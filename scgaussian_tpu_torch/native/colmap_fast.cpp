// Fast COLMAP points3D.bin parser.
//
// The reference parses points3D.bin with a per-record Python struct loop
// (scene/colmap_loader.py:156-187) — O(seconds) at ~1M points. This native
// walker parses the whole buffer in one pass; exposed via ctypes (no
// pybind11 in this environment), with a pure-Python fallback in
// data/colmap.py.
//
// Layout per record (little-endian):
//   uint64 point_id; 3x double xyz; 3x uint8 rgb; double error;
//   uint64 track_len; track_len x (int32 image_id, int32 point2d_idx)

#include <cstdint>
#include <cstring>

extern "C" {

// Returns the number of points, or -1 on malformed input.
// Pass nullptr outputs to only count. Buffers must hold `capacity` records.
long long parse_points3d(
    const unsigned char* buf,
    long long buf_len,
    long long capacity,
    double* xyz,        // [capacity * 3]
    unsigned char* rgb, // [capacity * 3]
    double* error,      // [capacity]
    unsigned long long* ids // [capacity]
) {
    if (buf_len < 8) return -1;
    unsigned long long num_points;
    std::memcpy(&num_points, buf, 8);
    const unsigned char* p = buf + 8;
    const unsigned char* end = buf + buf_len;

    for (unsigned long long i = 0; i < num_points; ++i) {
        // 8 id + 24 xyz + 3 rgb + 8 error + 8 track_len = 51 bytes minimum
        if (p + 51 > end) return -1;
        if (xyz != nullptr && (long long)i < capacity) {
            std::memcpy(&ids[i], p, 8);
            std::memcpy(&xyz[i * 3], p + 8, 24);
            std::memcpy(&rgb[i * 3], p + 32, 3);
            std::memcpy(&error[i], p + 35, 8);
        }
        unsigned long long track_len;
        std::memcpy(&track_len, p + 43, 8);
        p += 51 + 8 * track_len;
        if (p > end) return -1;
    }
    return (long long)num_points;
}

}  // extern "C"
