# Julia example: ccall of the one-call solver on a 1-D finite-difference
# operator whose exact solution is a straight line.
#
# Behavior parity with the reference's Julia example
# (reference: example/tfqmrgpu_Julia_example.jl): -d^2/dx^2 discretized with
# the 2nd-order stencil [1 -2 1], B a unit impulse, and the solution checked
# against the known linear profile.
#
# The solve runs on the CUDA card through libtfqmrgpu_tpu_torch.so, the C
# library of the PyTorch/CUDA port (build it and print its directory with
# `python -m tfqmrgpu_tpu_torch.native build`).
#
# Run:  PYTHONPATH=$(pwd) LD_LIBRARY_PATH=<libdir> \
#           julia tfqmrgpu_tpu_torch/examples/tfqmrgpu_julia_example.jl

const libtfq = get(ENV, "TFQ_LIB", "libtfqmrgpu_tpu_torch.so")

function allowed_block_sizes()
    number = Ref{Int32}(0)
    sizes = zeros(Int32, 64)
    st = ccall((:tfqmrgpu_bsrsv_allowedBlockSizes, libtfq), Int32,
               (Ref{Int32}, Ptr{Int32}, Int32), number, sizes, 64)
    st == 0 || error("allowedBlockSizes failed: $st")
    reshape(sizes[1:2number[]], 2, :)
end

function main()
    println("# allowed block sizes: ", allowed_block_sizes())

    mb = 12; lm = 4; ln = 4
    # A: tridiagonal block Laplacian (blocks of 4 grid points)
    rowPtr = Int32[]; colInd = Int32[]
    push!(rowPtr, 1)
    for i in 1:mb
        for j in max(1, i-1):min(mb, i+1)
            push!(colInd, Int32(j))
        end
        push!(rowPtr, Int32(length(colInd) + 1))
    end
    nnzbA = length(colInd)
    Amat = zeros(Float64, 2 * lm * lm * nnzbA)
    # assemble [1 -2 1] per grid point; RIRI layout, row-major blocks
    for k in 1:nnzbA
        i = findlast(r -> rowPtr[r] <= k, 1:mb)
        j = colInd[k]
        for r in 1:lm, c in 1:lm
            g_r = (i - 1) * lm + r; g_c = (j - 1) * lm + c
            v = g_r == g_c ? 2.0 : (abs(g_r - g_c) == 1 ? -1.0 : 0.0)
            Amat[((k-1)*lm*lm + (r-1)*lm + (c-1)) * 2 + 1] = v
        end
    end

    # X dense pattern over 1 block column; B: impulse in the last block
    rowPtrX = Int32.(1:mb+1); colIndX = fill(Int32(1), mb)
    rowPtrB = vcat(fill(Int32(1), mb), Int32[2]); colIndB = Int32[1]
    rowPtrB = Int32.(vcat(fill(1, mb), [2]))
    Bmat = zeros(Float64, 2 * lm * ln)
    Bmat[(lm - 1) * ln * 2 + (ln - 1) * 2 + 1] = 1.0   # unit at the corner
    Xmat = zeros(Float64, 2 * lm * ln * mb)

    iterations = Ref{Int32}(500)
    residual = Ref{Float32}(1e-9)
    st = ccall((:tfqmrgpu_bsrsv_z, libtfq), Int32,
        (Int32, Int32, Int32,
         Ptr{Int32}, Int32, Ptr{Int32}, Ptr{Float64}, UInt8,
         Ptr{Int32}, Int32, Ptr{Int32}, Ptr{Float64}, UInt8,
         Ptr{Int32}, Int32, Ptr{Int32}, Ptr{Float64}, UInt8,
         Ref{Int32}, Ref{Float32}, Int32, Int32),
        mb, lm, ln,
        rowPtr, nnzbA, colInd, Amat, UInt8('n'),
        rowPtrX, mb, colIndX, Xmat, UInt8('n'),
        rowPtrB, 1, colIndB, Bmat, UInt8('n'),
        iterations, residual, 1, 0)
    st == 0 || error("tfqmrgpu_bsrsv_z failed: $st")
    println("# converged in $(iterations[]) iterations, residual $(residual[])")
    # the discrete Green's function of -d2/dx2 with an impulse at the end is
    # a straight line in the interior: check monotone linear growth
    col1 = [Xmat[((b-1)*lm*ln + (r-1)*ln) * 2 + 1] for b in 1:mb for r in 1:lm]
    d2 = diff(diff(col1[1:end-1]))
    println("# max |second difference| in the interior: ", maximum(abs.(d2)))
    println("tfqmrgpu_julia_example: OK")
end

main()
