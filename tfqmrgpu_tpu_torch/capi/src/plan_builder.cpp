// Native analysis step ("createPlan") of the PyTorch/CUDA port.
//
// Reproduces the semantics of the reference's host-side plan construction
// (reference: tfQMRgpu/source/tfqmrgpu.cu:136-351):
//   * multiplication pair list (pairs/starts) by intersecting each A-row
//     pattern with the X-column membership, Y blocks in storage order and
//     A blocks of the row in storage order;
//   * subset list with the B-subset-of-X validation;
//   * column compression to uint16 colindx with empty-column filtering and
//     the zero-column-of-B hard error.
//
// Unlike the reference's linear find_in_array (bsr.hxx:27-39, which its own
// comment flags as a bisection candidate), membership queries run as binary
// searches over per-row sorted column copies: O(nnz log deg) total.  Its
// tables are bit-identical to tfqmrgpu_tpu_torch.plan.create_plan's.
//
// Exposed as a C ABI for ctypes (tfqmrgpu_tpu_torch/native.py); errors
// return the packed status codes negated (code + 1000*line payload,
// mirroring tfqmrgpu.h:179-181).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr long long kStatusBNotSubsetOfX = 13;
constexpr long long kStatusBHasZeroColumn = 11;
constexpr long long kStatusUndocumented = 14;
constexpr long long kCodeLine = 1000;

inline long long packed(long long code, long long payload) {
    return -(code + kCodeLine * payload);
}

// Per-row sorted view of a CSR pattern: cols sorted ascending with their
// original nnz index carried along, enabling binary-search membership.
struct SortedPattern {
    std::vector<int32_t> cols;   // 0-based, sorted within each row
    std::vector<int32_t> idx;    // original nnz index of each sorted slot
    const int32_t* rowptr;
    int off;                     // index offset of the rowptr array

    SortedPattern(int mb, const int32_t* rp, const int32_t* ci, int off_)
        : cols(static_cast<size_t>(rp[mb] - off_)),
          idx(static_cast<size_t>(rp[mb] - off_)), rowptr(rp), off(off_) {
        std::vector<std::pair<int32_t, int32_t>> tmp;
        for (int r = 0; r < mb; ++r) {
            const int64_t lo = rp[r] - off, hi = rp[r + 1] - off;
            tmp.clear();
            tmp.reserve(static_cast<size_t>(hi - lo));
            for (int64_t i = lo; i < hi; ++i)
                tmp.emplace_back(ci[i] - off, static_cast<int32_t>(i));
            std::sort(tmp.begin(), tmp.end());
            for (int64_t i = lo; i < hi; ++i) {
                cols[static_cast<size_t>(i)] = tmp[static_cast<size_t>(i - lo)].first;
                idx[static_cast<size_t>(i)] = tmp[static_cast<size_t>(i - lo)].second;
            }
        }
    }

    // nnz index (0-based) of block (row, col), both 0-based, or -1.
    int32_t find(int row, int32_t col) const {
        const int64_t lo = rowptr[row] - off, hi = rowptr[row + 1] - off;
        const int32_t* first = cols.data() + lo;
        const int32_t* last = cols.data() + hi;
        const int32_t* it = std::lower_bound(first, last, col);
        if (it == last || *it != col) return -1;
        return idx[static_cast<size_t>(it - cols.data())];
    }
};

}  // namespace

extern "C" {

// Pass 1: count multiplication pairs per Y block.
// starts must hold nnzbX+1 entries; filled with the exclusive prefix sum.
// Returns the total number of pairs, or a negated packed status.
long long tfq_plan_pairs_count(
    int mb, int index_offset,
    const int32_t* rowptr_a, const int32_t* colind_a,
    const int32_t* rowptr_x, const int32_t* colind_x,
    uint32_t* starts) {
    if (mb < 1) return packed(kStatusUndocumented, 1);
    const int off = index_offset;
    const int64_t nnzb_x = rowptr_x[mb] - off;
    if (nnzb_x < 1) return packed(kStatusUndocumented, 2);

    SortedPattern xpat(mb, rowptr_x, colind_x, off);

    long long total = 0;
    starts[0] = 0;
    int64_t iy = 0;
    for (int row = 0; row < mb; ++row) {
        const int64_t xlo = rowptr_x[row] - off, xhi = rowptr_x[row + 1] - off;
        const int64_t alo = rowptr_a[row] - off, ahi = rowptr_a[row + 1] - off;
        for (int64_t ix = xlo; ix < xhi; ++ix, ++iy) {
            const int32_t jcol = colind_x[ix] - off;
            int cnt = 0;
            for (int64_t ia = alo; ia < ahi; ++ia) {
                const int32_t k = colind_a[ia] - off;
                if (xpat.find(k, jcol) >= 0) ++cnt;
            }
            total += cnt;
            starts[iy + 1] = starts[iy] + static_cast<uint32_t>(cnt);
        }
    }
    return total;
}

// Pass 2: fill pairs[2*n_pairs] with interleaved (iA, iX), in the exact
// reference order (Y storage order; A blocks of the row in storage order).
long long tfq_plan_pairs_fill(
    int mb, int index_offset,
    const int32_t* rowptr_a, const int32_t* colind_a,
    const int32_t* rowptr_x, const int32_t* colind_x,
    uint32_t* pairs) {
    const int off = index_offset;
    SortedPattern xpat(mb, rowptr_x, colind_x, off);

    long long n = 0;
    for (int row = 0; row < mb; ++row) {
        const int64_t xlo = rowptr_x[row] - off, xhi = rowptr_x[row + 1] - off;
        const int64_t alo = rowptr_a[row] - off, ahi = rowptr_a[row + 1] - off;
        for (int64_t ix = xlo; ix < xhi; ++ix) {
            const int32_t jcol = colind_x[ix] - off;
            for (int64_t ia = alo; ia < ahi; ++ia) {
                const int32_t k = colind_a[ia] - off;
                const int32_t inzx = xpat.find(k, jcol);
                if (inzx >= 0) {
                    pairs[2 * n] = static_cast<uint32_t>(ia);
                    pairs[2 * n + 1] = static_cast<uint32_t>(inzx);
                    ++n;
                }
            }
        }
    }
    return n;
}

// Subset list: subset[nnzbB] = X nnz index of each B block.
// Returns 0, or the negated packed B_IS_NOT_SUBSET_OF_X status with the
// offending block row as payload (reference: tfqmrgpu.cu:233-251).
long long tfq_plan_subset(
    int mb, int index_offset,
    const int32_t* rowptr_x, const int32_t* colind_x,
    const int32_t* rowptr_b, const int32_t* colind_b,
    uint32_t* subset) {
    const int off = index_offset;
    SortedPattern xpat(mb, rowptr_x, colind_x, off);
    int64_t ib = 0;
    for (int row = 0; row < mb; ++row) {
        const int64_t blo = rowptr_b[row] - off, bhi = rowptr_b[row + 1] - off;
        for (int64_t i = blo; i < bhi; ++i, ++ib) {
            const int32_t inzx = xpat.find(row, colind_b[i] - off);
            if (inzx < 0) return packed(kStatusBNotSubsetOfX, row);
            subset[ib] = static_cast<uint32_t>(inzx);
        }
    }
    return 0;
}

// Column compression (reference: tfqmrgpu.cu:254-339): maps the RAW X column
// indices onto compressed ids with empty columns filtered.  Fills
// colindx[nnzbX] (uint16) and original_cols[ncols]; validates every
// compressed column holds at least one B block via subset[nnzbB].
// Returns ncols, or a negated packed status (B_HAS_A_ZERO_COLUMN payload =
// number of empty B columns; line payloads mirror plan.py).
long long tfq_plan_compress_columns(
    long long nnzb_x, const int32_t* colind_x_raw,
    long long nnzb_b, const uint32_t* subset,
    uint16_t* colindx, int32_t* original_cols) {
    if (nnzb_x < 1) return packed(kStatusUndocumented, 6);
    int32_t min_col = colind_x_raw[0], max_col = colind_x_raw[0];
    for (long long i = 1; i < nnzb_x; ++i) {
        min_col = std::min(min_col, colind_x_raw[i]);
        max_col = std::max(max_col, colind_x_raw[i]);
    }
    const int64_t ncand = static_cast<int64_t>(max_col) - min_col + 1;
    std::vector<int32_t> translate(static_cast<size_t>(ncand), -1);
    for (long long i = 0; i < nnzb_x; ++i)
        translate[static_cast<size_t>(colind_x_raw[i] - min_col)] = 0;
    int64_t nb = 0;
    for (int64_t c = 0; c < ncand; ++c) {
        if (translate[static_cast<size_t>(c)] == 0) {
            translate[static_cast<size_t>(c)] = static_cast<int32_t>(nb);
            original_cols[nb] = static_cast<int32_t>(c + min_col);
            ++nb;
        }
    }
    if (nb > 65536) return packed(kStatusUndocumented, 7);
    for (long long i = 0; i < nnzb_x; ++i)
        colindx[i] = static_cast<uint16_t>(
            translate[static_cast<size_t>(colind_x_raw[i] - min_col)]);

    std::vector<uint8_t> has_b(static_cast<size_t>(nb), 0);
    for (long long i = 0; i < nnzb_b; ++i)
        has_b[colindx[subset[i]]] = 1;
    int64_t nzero = 0;
    for (int64_t c = 0; c < nb; ++c) nzero += (has_b[static_cast<size_t>(c)] == 0);
    if (nzero > 0) return packed(kStatusBHasZeroColumn, nzero);
    return nb;
}

}  // extern "C"
