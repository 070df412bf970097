// Host voxel-grid downsampling and the KITTI .bin reader, in C++
// (the port's copy of deeppointmap_tpu/native/voxel_native.cpp).
//
// The reference's voxel stage routes through Open3D/NumPy sort+unique
// (reference: dataloader/transforms.py:322-356); this is the same
// semantics ('first' retention) as a single open-addressing hash pass over
// the raw scan -- O(N) instead of O(N log N), no Python
// object overhead. Built with g++ at first use and bound with ctypes by
// deeppointmap_tpu_torch/native/__init__.py, which raises when the build
// fails: the NumPy route (data/voxel.py) is the plain version the tests
// hold this one against, not a fallback. 'center' retention stays NumPy
// (data/voxel.py says why), so the JAX copy's 'center' pass is not here.

#include <cstdint>
#include <cmath>
#include <vector>

namespace {

inline uint64_t hash_key(int64_t k) {
    uint64_t h = static_cast<uint64_t>(k);
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    return h;
}

}  // namespace

extern "C" {

// xyz: (n, 3) float32, voxel_size > 0; keeps the first point of each voxel.
// out_idx: preallocated int32 buffer of capacity n; returns the number of
// retained indices written (one per occupied voxel, in first-seen order).
// The voxel coordinates are float32 (x - min) / voxel_size truncated, the
// arithmetic of data/voxel.voxel_ids on float32 input.
int voxel_downsample(const float* xyz, int64_t n, float voxel_size,
                     int32_t* out_idx) {
    if (n <= 0) return 0;
    float mn[3] = {xyz[0], xyz[1], xyz[2]};
    for (int64_t i = 1; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            float v = xyz[i * 3 + d];
            if (v < mn[d]) mn[d] = v;
        }
    }
    // grid dims for collision-free linearization
    int64_t dims[3] = {1, 1, 1};
    for (int64_t i = 0; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            int64_t c = static_cast<int64_t>((xyz[i * 3 + d] - mn[d]) / voxel_size);
            if (c + 1 > dims[d]) dims[d] = c + 1;
        }
    }

    // open addressing over linearized voxel ids (-1 = empty),
    // power-of-two capacity >= 2n
    uint64_t cap = 1;
    while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
    std::vector<int64_t> table(cap, -1);

    int64_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t cx = static_cast<int64_t>((xyz[i * 3 + 0] - mn[0]) / voxel_size);
        int64_t cy = static_cast<int64_t>((xyz[i * 3 + 1] - mn[1]) / voxel_size);
        int64_t cz = static_cast<int64_t>((xyz[i * 3 + 2] - mn[2]) / voxel_size);
        int64_t key = cx + cy * dims[0] + cz * dims[0] * dims[1];

        uint64_t h = hash_key(key) & (cap - 1);
        while (table[h] != -1 && table[h] != key) h = (h + 1) & (cap - 1);
        if (table[h] == -1) {
            table[h] = key;
            out_idx[k++] = static_cast<int32_t>(i);
        }
    }
    return static_cast<int>(k);
}

// KITTI .bin reader: (n, 4) float32 x/y/z/intensity -> xyz only with NaN
// rows dropped (reference: dataloader/heads/bin.py:12-25). Returns number
// of valid points written to out (capacity n_rows * 3 floats).
int read_kitti_xyz(const float* raw, int64_t n_rows, float* out) {
    int64_t k = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        float x = raw[i * 4], y = raw[i * 4 + 1], z = raw[i * 4 + 2];
        if (std::isnan(x) || std::isnan(y) || std::isnan(z)) continue;
        out[k * 3] = x;
        out[k * 3 + 1] = y;
        out[k * 3 + 2] = z;
        ++k;
    }
    return static_cast<int>(k);
}

}  // extern "C"
