"""Device-memory -> shared-memory stream probe on one CUDA card.

    python -m tfqmrgpu_tpu_torch.dma_probe [out.json]

The counterpart of ``tools/dma_probe.py`` (the TPU kernel K4, which measured
the HBM->VMEM rate of Pallas's grid pipeline).  ``StreamProbe(stage_bytes)``
computes

    out[rows, 128] = sum over ops, steps of x[op, step, :, :128]

for x [n_ops, nsteps, rows, cols] float32.  On a CUDA tensor it launches
``csrc/dma_probe.cu``, which copies every byte of x into shared memory with
``cp.async`` in stages of ``stage_bytes``; on a CPU tensor it runs the plain
version.  ``sweep`` times the kernel over stage sizes and operand counts,
at least 1 GiB per variant (far beyond the 50 MB L2), and sets beside it the
library yardstick, ``torch.Tensor.copy_`` of the same bytes on the card
(read and write bytes both counted).  Its rates, over the card's 3.35 TB/s,
are the device-memory ceiling the port's kernel bounds are read against.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from .errors import Status, TfqmrgpuError, encode_status
from .profiling import DEVICE_PEAKS, H100

HBM_BYTES_PER_S = DEVICE_PEAKS[H100]["hbm_gbps"] * 1e9
STAGE_BYTES = (16 << 10, 32 << 10, 64 << 10, 96 << 10)
N_OPS = (1, 2, 4)
ROWS, COLS = 64, 1024               # one [rows, cols] block: 256 KiB
SLICE = 128


def plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device."""
    return x[..., :SLICE].sum(dim=(0, 1))


class StreamProbe:
    """The probe's wrapper.  ``launches`` counts kernel launches by every
    instance in this process; the plain version never adds to it."""

    launches: int = 0

    def __init__(self, stage_bytes: int):
        self.stage_bytes = int(stage_bytes)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("x must be a contiguous [n_ops, nsteps, rows, "
                             f"cols] float32 tensor, got {tuple(x.shape)} "
                             f"{x.dtype}")
        n_ops, nsteps, rows, cols = (int(s) for s in x.shape)
        if rows % 2 or rows > 64 or cols < SLICE or cols % 4 \
                or self.stage_bytes % (16 * n_ops):
            raise ValueError(f"the probe takes even rows <= 64, cols >= {SLICE} "
                             "in multiples of 4 and stages of 16*n_ops bytes; "
                             f"got rows={rows} cols={cols} n_ops={n_ops} "
                             f"stage_bytes={self.stage_bytes}")
        if x.device.type == "cpu":
            return plain(x)
        if x.device.type != "cuda":
            raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                                f"no stream probe for {x.device}")
        return self._launch(x, n_ops, nsteps, rows, cols)

    def _launch(self, x, n_ops, nsteps, rows, cols) -> torch.Tensor:
        from ._build import load_kernels

        lib = load_kernels()
        with torch.cuda.device(x.device):
            ctas = lib.tfq_dma_probe_ctas(self.stage_bytes, n_ops)
            if ctas <= 0:
                raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                    f"probe occupancy query returned {ctas}")
            partial = torch.empty((ctas, rows, SLICE), dtype=torch.float32,
                                  device=x.device)
            out = torch.empty((rows, SLICE), dtype=torch.float32,
                              device=x.device)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.tfq_dma_probe_f32(x.data_ptr(), n_ops, nsteps, rows,
                                       cols, self.stage_bytes, ctas,
                                       partial.data_ptr(), out.data_ptr(),
                                       stream)
        if rc != 0:
            raise TfqmrgpuError(encode_status(Status.LAUNCH_FAILED),
                                f"stream probe returned {rc}")
        StreamProbe.launches += 1
        return out


def time_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operands(n_ops: int, total_bytes: int, device, seed: int = 0):
    """x [n_ops, nsteps, ROWS, COLS] of normal numbers, ``total_bytes`` in
    all, drawn on ``device`` from a seeded generator."""
    nsteps = max(1, total_bytes // (n_ops * ROWS * COLS * 4))
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n_ops, nsteps, ROWS, COLS), generator=gen,
                       device=device, dtype=torch.float32)


def sweep(device="cuda", total_bytes: int = 1 << 30,
          stage_bytes=STAGE_BYTES, n_ops=N_OPS) -> dict:
    """Time the kernel at every (stage size, operand count), each result
    held against the plain version (maxdev relative to the largest entry,
    gate 1e-4: float32 sums of ``nsteps*n_ops`` terms in two orders), and
    the ``copy_`` yardstick of the same bytes.  Needs a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise TfqmrgpuError(encode_status(Status.NO_IMPLEMENTATION),
                            "the probe measures a CUDA device")
    rows = []
    copies = {}
    for k in n_ops:
        x = operands(k, total_bytes, device, seed=k)
        want = plain(x)
        scale = float(want.abs().max())
        nbytes = x.numel() * 4
        for sb in stage_bytes:
            probe = StreamProbe(sb)
            got = probe(x)
            abs_err = float((got - want).abs().max())
            maxdev = abs_err / scale
            if not maxdev <= 1e-4:
                raise RuntimeError(f"probe stage {sb} n_ops {k}: maxdev "
                                   f"{maxdev:.3e} > 1e-4")
            ms = time_ms(lambda: probe(x))
            rows.append(dict(stage_kb=sb >> 10, n_ops=k,
                             nsteps=int(x.shape[1]), bytes=nbytes, ms=ms,
                             gbps=nbytes / ms / 1e6,
                             share=nbytes / ms / 1e-3 / HBM_BYTES_PER_S,
                             maxdev=maxdev, max_abs_err=abs_err))
        plain_ms = time_ms(lambda: plain(x))
        dst = torch.empty_like(x)
        copy_ms = time_ms(lambda: dst.copy_(x))
        copies[k] = dict(n_ops=k, bytes=nbytes, plain_ms=plain_ms,
                         copy_ms=copy_ms, copy_gbps=2 * nbytes / copy_ms / 1e6,
                         copy_share=2 * nbytes / copy_ms / 1e-3
                         / HBM_BYTES_PER_S)
        del x, dst
    return dict(variants=rows, yardsticks=list(copies.values()))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the stream probe needs a CUDA device; none is "
                         "available")
    res = sweep()
    for r in res["variants"]:
        print(f"stage {r['stage_kb']:3d} KiB n_ops {r['n_ops']}: "
              f"{r['gbps']:.1f} GB/s ({100 * r['share']:.1f}% of 3.35 TB/s), "
              f"{r['ms']:.4f} ms, maxdev {r['maxdev']:.2e}", flush=True)
    for y in res["yardsticks"]:
        print(f"n_ops {y['n_ops']}: copy_ {y['copy_gbps']:.1f} GB/s read+write "
              f"({100 * y['copy_share']:.1f}%), plain {y['plain_ms']:.4f} ms",
              flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
