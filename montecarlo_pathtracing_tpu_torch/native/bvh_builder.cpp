// Native BVH builder: complete-binary-tree median split, cyclic axes.
//
// The port's copy of montecarlo_pathtracing_tpu/native/bvh_builder.cpp, a
// host-side C++ component (the analog of the reference's BVH_KDtree,
// bvh_gpu/bvh.cpp:34-93): produces the identical output format —
// heap-ordered boxes [2^(d+1)-1] and leaf prim ids [2^d] with -1 holes —
// and bit-identical arrays to the Python builder (scene/bvh_builder.py).
//
// Ordering contract shared with the Python builder: each level's segments
// are stable-sorted by the level axis (the reference's nth_element leaves
// intra-segment order unspecified; we normalize it so the two builders
// agree exactly and tests can assert equality).
//
// Build: g++ -O3 -shared -fPIC into the package's _build/ (driven by
// native/bvh_native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// centers/bbmin/bbmax: [n*3] row-major f32.
// out_bbmin/out_bbmax: [(2^(depth+1)-1)*3]; out_leaf: [2^depth].
// Returns depth; caller sizes outputs from mpt_bvh_depth(n).
int mpt_bvh_depth(int n) {
    if (n <= 1) return 0;
    return (int)std::ceil(std::log2((float)n));
}

void mpt_build_bvh(const float* centers, const float* bbmin,
                   const float* bbmax, int n,
                   float* out_bbmin, float* out_bbmax, int32_t* out_leaf) {
    if (n == 1) {
        for (int c = 0; c < 3; ++c) {
            out_bbmin[c] = bbmin[c];
            out_bbmax[c] = bbmax[c];
        }
        out_leaf[0] = 0;
        return;
    }
    int depth = mpt_bvh_depth(n);

    std::vector<int32_t> ids(n);
    for (int i = 0; i < n; ++i) ids[i] = i;
    std::vector<int64_t> splt = {0, n};

    int axis = 0;
    for (int level = 1; level < depth; ++level) {
        std::vector<int64_t> splt2 = {splt[0]};
        for (size_t i = 1; i < splt.size(); ++i) {
            int64_t j0 = splt[i - 1], j2 = splt[i];
            int64_t j1 = (j0 + j2) / 2;
            std::stable_sort(
                ids.begin() + j0, ids.begin() + j2,
                [&](int32_t a, int32_t b) {
                    return centers[a * 3 + axis] < centers[b * 3 + axis];
                });
            splt2.push_back(j1);
            splt2.push_back(j2);
        }
        splt.swap(splt2);
        axis = (axis + 1) % 3;
    }

    const int64_t sz_leaf = 1LL << depth;
    const int64_t sz = 2 * sz_leaf - 1;

    // leaf fill, back-to-front (bvh.cpp:59-83)
    int64_t j = sz - 1, k = sz_leaf - 1;
    for (size_t i = splt.size() - 1; i > 0; --i) {
        int64_t a = splt[i - 1];
        if (splt[i] - a == 1) {
            int32_t id = ids[a];
            out_leaf[k] = -1;
            out_leaf[k - 1] = id;
            for (int c = 0; c < 3; ++c) {
                out_bbmin[j * 3 + c] = bbmin[id * 3 + c];
                out_bbmax[j * 3 + c] = bbmax[id * 3 + c];
                out_bbmin[(j - 1) * 3 + c] = bbmin[id * 3 + c];
                out_bbmax[(j - 1) * 3 + c] = bbmax[id * 3 + c];
            }
        } else {
            int32_t id1 = ids[a + 1], id0 = ids[a];
            out_leaf[k] = id1;
            out_leaf[k - 1] = id0;
            for (int c = 0; c < 3; ++c) {
                out_bbmin[j * 3 + c] = bbmin[id1 * 3 + c];
                out_bbmax[j * 3 + c] = bbmax[id1 * 3 + c];
                out_bbmin[(j - 1) * 3 + c] = bbmin[id0 * 3 + c];
                out_bbmax[(j - 1) * 3 + c] = bbmax[id0 * 3 + c];
            }
        }
        k -= 2;
        j -= 2;
    }

    // bottom-up merge (bvh.cpp:85-91)
    for (int64_t kk = sz - 1; kk >= 2; kk -= 2) {
        int64_t p = (kk - 2) / 2;
        for (int c = 0; c < 3; ++c) {
            out_bbmin[p * 3 + c] =
                std::min(out_bbmin[kk * 3 + c], out_bbmin[(kk - 1) * 3 + c]);
            out_bbmax[p * 3 + c] =
                std::max(out_bbmax[kk * 3 + c], out_bbmax[(kk - 1) * 3 + c]);
        }
    }
}

}  // extern "C"
