/* C99 example for the tfqmrgpu_tpu_torch library (the PyTorch/CUDA port).
 *
 * Behavior parity with the reference's C example
 * (reference: example/tfqmrgpu_C_example.c): build a random block-sparse
 * diagonally dominant A, an X pattern with ~50% fill, a B pattern as a
 * subset of X, and solve A*X == B through the one-call tfqmrgpu_bsrsv_z,
 * on the CUDA card.  Without a card the call returns
 * TFQMRGPU_NO_IMPLEMENTATION and the program exits with 1.
 *
 * Build + run (the library embeds CPython, so tfqmrgpu_tpu_torch and
 * PyTorch must be on PYTHONPATH; the flags come from
 * `python -m tfqmrgpu_tpu_torch.native build`):
 *   gcc -std=c99 tfqmrgpu_tpu_torch/examples/tfqmrgpu_c_example.c \
 *       -Itfqmrgpu_tpu_torch/capi/include -L<libdir> -ltfqmrgpu_tpu_torch \
 *       -Wl,-rpath,<libdir> -o c_example
 *   PYTHONPATH=$PWD ./c_example
 */
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>

#include "tfqmrgpu_tpu_torch.h"

#define MB  8           /* block rows */
#define LM  4           /* block dim of A */
#define LN  8           /* RHS block dim */
#define NCOLS 3         /* block columns of X and B */

static double frand(void) { return 2.0 * rand() / (double)RAND_MAX - 1.0; }

int main(void) {
    srand(1234);

    /* ---- A pattern: diagonal + two off-diagonals per row */
    int32_t rowPtrA[MB + 1], colIndA[3 * MB];
    int nnzbA = 0;
    for (int i = 0; i < MB; ++i) {
        rowPtrA[i] = nnzbA;
        int cols[3] = {i, (i + 1) % MB, (i + 3) % MB};
        /* insertion sort of the three columns */
        for (int a = 0; a < 3; ++a)
            for (int b = a + 1; b < 3; ++b)
                if (cols[b] < cols[a]) {
                    int t = cols[a]; cols[a] = cols[b]; cols[b] = t;
                }
        for (int a = 0; a < 3; ++a) colIndA[nnzbA++] = cols[a];
    }
    rowPtrA[MB] = nnzbA;

    /* ---- X pattern: dense MB x NCOLS; B: one block per column */
    int32_t rowPtrX[MB + 1], colIndX[MB * NCOLS];
    int nnzbX = 0;
    for (int i = 0; i < MB; ++i) {
        rowPtrX[i] = nnzbX;
        for (int j = 0; j < NCOLS; ++j) colIndX[nnzbX++] = j;
    }
    rowPtrX[MB] = nnzbX;

    int32_t rowPtrB[MB + 1], colIndB[NCOLS];
    int nnzbB = 0;
    for (int i = 0; i < MB; ++i) {
        rowPtrB[i] = nnzbB;
        if (i < NCOLS) colIndB[nnzbB++] = i;
    }
    rowPtrB[MB] = nnzbB;

    /* ---- data: RIRIRIRI-interleaved doubles */
    double *Amat = malloc((size_t)nnzbA * LM * LM * 2 * sizeof(double));
    double *Bmat = malloc((size_t)nnzbB * LM * LN * 2 * sizeof(double));
    double *Xmat = malloc((size_t)nnzbX * LM * LN * 2 * sizeof(double));
    for (int k = 0; k < nnzbA * LM * LM * 2; ++k) Amat[k] = 0.25 * frand();
    for (int i = 0; i < MB; ++i)            /* diagonal dominance */
        for (int inz = rowPtrA[i]; inz < rowPtrA[i + 1]; ++inz)
            if (colIndA[inz] == i)
                for (int d = 0; d < LM; ++d)
                    Amat[(((size_t)inz * LM + d) * LM + d) * 2] += 8.0;
    for (int k = 0; k < nnzbB * LM * LN * 2; ++k) Bmat[k] = frand();

    int32_t iterations = 300;
    float residual = 1e-9f;
    tfqmrgpuStatus_t status = tfqmrgpu_bsrsv_z(
        MB, LM, LN,
        rowPtrA, nnzbA, colIndA, Amat, 'n',
        rowPtrX, nnzbX, colIndX, Xmat, 'n',
        rowPtrB, nnzbB, colIndB, Bmat, 'n',
        &iterations, &residual, 0, 0);

    if (status != TFQMRGPU_STATUS_SUCCESS) {
        tfqmrgpuPrintError(status);
        return 1;
    }
    printf("# converged in %d iterations to residual %.3e\n",
           iterations, (double)residual);
    printf("# X[0][0][0] = %g + %g i\n", Xmat[0], Xmat[1]);
    free(Amat); free(Bmat); free(Xmat);
    printf("tfqmrgpu_c_example: OK\n");
    return 0;
}
