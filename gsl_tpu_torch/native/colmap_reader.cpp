// Fast COLMAP points3D.bin reader.
//
// A copy of gsl_tpu/native/colmap_reader.cpp for the port, built by
// gsl_tpu_torch/native/__init__.py with g++ and loaded with ctypes. The
// plain version, and the reference for its arrays, is the Python loop of
// gsl_tpu_torch/data/colmap_io.py::read_points3d_bin_plain. City-scale
// sparse models hold millions of points with tracks of any length; the
// Python loop makes five reads a point, this reads the file once and
// parses it in memory.
//
// C ABI (ctypes):
//   int64 colmap_count_points3d(const char* path);
//   int64 colmap_read_points3d(const char* path, double* xyz, uint8_t* rgb,
//                              double* err);  // caller-allocated, returns n
// Both return -1 when the file cannot be read or ends early.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Buf {
    std::vector<unsigned char> data;
    size_t pos = 0;

    bool load(const char* path) {
        FILE* f = std::fopen(path, "rb");
        if (!f) return false;
        std::fseek(f, 0, SEEK_END);
        long size = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        data.resize(static_cast<size_t>(size));
        size_t got = std::fread(data.data(), 1, data.size(), f);
        std::fclose(f);
        return got == data.size();
    }

    template <typename T>
    bool read(T* out, size_t count = 1) {
        size_t bytes = sizeof(T) * count;
        if (pos + bytes > data.size()) return false;
        std::memcpy(out, data.data() + pos, bytes);
        pos += bytes;
        return true;
    }

    bool skip(size_t bytes) {
        if (pos + bytes > data.size()) return false;
        pos += bytes;
        return true;
    }
};

}  // namespace

extern "C" {

int64_t colmap_count_points3d(const char* path) {
    Buf b;
    if (!b.load(path)) return -1;
    uint64_t n = 0;
    if (!b.read(&n)) return -1;
    return static_cast<int64_t>(n);
}

// xyz: [n*3] f64, rgb: [n*3] u8, err: [n] f64 (caller-allocated)
int64_t colmap_read_points3d(const char* path, double* xyz, uint8_t* rgb,
                             double* err) {
    Buf b;
    if (!b.load(path)) return -1;
    uint64_t n = 0;
    if (!b.read(&n)) return -1;
    for (uint64_t i = 0; i < n; ++i) {
        if (!b.skip(8)) return -1;                    // point id (int64)
        if (!b.read(xyz + i * 3, 3)) return -1;       // xyz f64
        if (!b.read(rgb + i * 3, 3)) return -1;       // rgb u8
        if (!b.read(err + i)) return -1;              // error f64
        uint64_t track_len = 0;
        if (!b.read(&track_len)) return -1;
        if (!b.skip(track_len * 8)) return -1;        // (img_id, pt2d) i32x2
    }
    return static_cast<int64_t>(n);
}

}  // extern "C"
