"""Which elementwise pass reaches the card's memory rate, on one CUDA card.

    python3 -m tfqmrgpu_tpu_torch.tools.elementwise_rate

Times three chains of 8 passes over a 512 MiB float32 tensor, each with
CUDA events, best of 3 after a warm-up, ended by a host read of the
result, and prints their read+write GB/s, twice in turns:

* ``a + c`` with ``c`` a 0-d device tensor read from the previous pass
  (the JAX package's ``calibrate_hbm`` chain, which XLA fuses): a stride-0
  operand;
* ``a + k`` with ``k`` a different host constant each pass (the port's
  ``profiling.calibrate_hbm``);
* ``copy_`` (the yardstick of ``chip_smoke.py`` phase 8).

The evidence for the form ``calibrate_hbm`` takes: PyTorch runs the first
without the vectorized loads of its elementwise kernel.
"""

from __future__ import annotations

import subprocess

import torch

NREP = 8


def main():
    if not torch.cuda.is_available():
        raise SystemExit("elementwise_rate needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    a = torch.ones(512 * (1 << 20) // 4, dtype=torch.float32, device=dev)
    y = torch.empty_like(a)

    def device_scalar(c0):
        c = torch.full((), c0, dtype=torch.float32, device=dev)
        for _ in range(NREP):
            torch.add(a, c, out=y)
            c = y[0] * 0.5 + 1e-9
        return c

    def host_scalar(c0):
        for k in range(NREP):
            torch.add(a, c0 + k, out=y)
        return y[0]

    def copy(c0):
        for _ in range(NREP):
            y.copy_(a)
        return y[0]

    def timed(fn, c0):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(c0)
        end.record()
        float(out)
        return start.elapsed_time(end) / 1e3

    for _ in range(2):
        for name, fn in (("a + c, c a device scalar", device_scalar),
                         ("a + k, k a host constant", host_scalar),
                         ("copy_", copy)):
            fn(1.0)
            best = min(timed(fn, 2.0 + i) for i in range(3))
            print(f"{name}: {a.numel() * 4 * 2 / 1e9 / (best / NREP):.1f} "
                  "GB/s read+write")


if __name__ == "__main__":
    main()
