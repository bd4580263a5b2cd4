// treeqp_host — native host-side runtime for treeqp_tpu_torch.
//
// The port's own copy of the host library (no file is shared with another
// package): the tree graph construction (treeqp/utils/tree.c: tree_create,
// setup_multistage_tree), the level scheduler behind the per-depth batched
// sweeps, and the padded stacked-array packer that replaces the reference's
// arena-carved BLASFEO matrices (treeqp/utils/memory.c) with the padded
// [nn, rmax, cmax] layout the port's tensors take.
//
// Exposed as a C ABI consumed from Python via ctypes
// (treeqp_tpu_torch/utils/native.py builds it with g++ on first use). All
// functions are allocation-free: the caller provides outputs, mirroring the
// reference's calculate_size/create discipline. Host code only: no device
// work happens here.

#include <cstdint>
#include <cstring>

extern "C" {

// Build topology arrays from children counts (tree_create semantics,
// tree.c:171-243: children of node i are the next unassigned nodes, which
// yields BFS / stage-contiguous numbering).
// Returns 0 on success, -1 on inconsistent nk.
int tqp_build_topology(const int32_t* nk, int32_t nn,
                       int32_t* parent, int32_t* stage, int32_t* sib_index,
                       int32_t* nkids_out) {
    if (nn <= 0) return -1;
    parent[0] = -1;
    stage[0] = 0;
    sib_index[0] = 0;
    int64_t next = 1;
    for (int32_t i = 0; i < nn; ++i) {
        nkids_out[i] = nk[i];
        for (int32_t j = 0; j < nk[i]; ++j) {
            if (next >= nn) return -1;
            parent[next] = i;
            stage[next] = stage[i] + 1;
            sib_index[next] = j;
            ++next;
        }
    }
    return next == nn ? 0 : -1;
}

// Multistage children counts (setup_multistage_tree, tree.c:247-280).
// nk must have room for the full node count; returns the node count.
int64_t tqp_multistage_nk(int32_t md, int32_t Nr, int32_t Nh, int32_t* nk) {
    int64_t idx = 0;
    int64_t in_stage = 1;
    for (int32_t k = 0; k < Nh; ++k) {
        int32_t kids = (k < Nr) ? md : 1;
        for (int64_t i = 0; i < in_stage; ++i) nk[idx + i] = kids;
        idx += in_stage;
        in_stage *= kids;
    }
    for (int64_t i = 0; i < in_stage; ++i) nk[idx + i] = 0;
    return idx + in_stage;
}

// Level schedule: counts per stage (the widths of the batched per-depth
// sweeps). stage must be nondecreasing (BFS order). n_stages = max+1.
int32_t tqp_stage_counts(const int32_t* stage, int32_t nn, int32_t* counts,
                         int32_t max_stages) {
    int32_t ns = 0;
    for (int32_t i = 0; i < max_stages; ++i) counts[i] = 0;
    for (int32_t i = 0; i < nn; ++i) {
        if (stage[i] >= max_stages) return -1;
        counts[stage[i]] += 1;
        if (stage[i] + 1 > ns) ns = stage[i] + 1;
    }
    return ns;
}

// Pack per-node column-major blocks (the reference setters' colmajor
// convention, tree_qp_common.c:874-2427) into one zero-padded row-major
// stacked array dst[nn, rmax, cmax]. offsets[i] = start of node i's block
// in src; rows/cols = its true dims.
void tqp_pack_colmajor(const double* src, const int64_t* offsets,
                       const int32_t* rows, const int32_t* cols,
                       int32_t nn, int32_t rmax, int32_t cmax, double* dst) {
    const int64_t node_sz = (int64_t)rmax * cmax;
    std::memset(dst, 0, (int64_t)nn * node_sz * sizeof(double));
    for (int32_t n = 0; n < nn; ++n) {
        const double* s = src + offsets[n];
        double* d = dst + (int64_t)n * node_sz;
        const int32_t r = rows[n], c = cols[n];
        for (int32_t j = 0; j < c; ++j)
            for (int32_t i = 0; i < r; ++i)
                d[(int64_t)i * cmax + j] = s[(int64_t)j * r + i];
    }
}

// Unpack the padded stacked array back to contiguous per-node column-major
// blocks (solution export path).
void tqp_unpack_colmajor(const double* src, const int64_t* offsets,
                         const int32_t* rows, const int32_t* cols,
                         int32_t nn, int32_t rmax, int32_t cmax, double* dst) {
    const int64_t node_sz = (int64_t)rmax * cmax;
    for (int32_t n = 0; n < nn; ++n) {
        const double* s = src + (int64_t)n * node_sz;
        double* d = dst + offsets[n];
        const int32_t r = rows[n], c = cols[n];
        for (int32_t j = 0; j < c; ++j)
            for (int32_t i = 0; i < r; ++i)
                d[(int64_t)j * r + i] = s[(int64_t)i * cmax + j];
    }
}

}  // extern "C"
