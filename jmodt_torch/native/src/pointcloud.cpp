// Native point-cloud loader: the per-frame host path of the data
// pipeline (velodyne .bin read -> lidar->rect projection -> rect->image
// projection -> in-image / in-range filtering), fused into one pass over
// the raw points.
//
// The host work the reference does in numpy per frame
// (jmodt/detection/datasets/kitti_dataset.py:219-229 plus
// jmodt/utils/calibration.py:50-69) materializes five intermediate arrays
// per frame; this version streams each point through registers once.
// The same source and flags as jmodt_tpu/native/src/pointcloud.cpp, so
// both libraries return the same bits.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (jmodt_torch/native/__init__.py)
// Binding: ctypes (jmodt_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Load a KITTI velodyne .bin (float32 x,y,z,intensity rows).
// Returns the number of points read, or -1 on IO failure.
// `capacity` bounds the write into `out` (4 floats per point).
int64_t load_velodyne(const char* path, float* out, int64_t capacity) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int64_t n = 0;
    const int64_t chunk = 4096;
    while (n < capacity) {
        int64_t want = capacity - n < chunk ? capacity - n : chunk;
        int64_t got = (int64_t)fread(out + 4 * n, sizeof(float) * 4,
                                     (size_t)want, f);
        n += got;
        if (got < want) break;
    }
    fclose(f);
    return n;
}

// Fused projection + filtering.
//
//   pts_lidar: (n, 4) velodyne rows [x, y, z, intensity]
//   v2c_r0:    (3, 4) row-major combined transform R0 @ [V2C] so that
//              rect = v2c_r0 @ [x, y, z, 1]^T  (host precomputes the
//              product of calibration.py's V2C and R0)
//   p2:        (3, 4) row-major camera projection
//   img_h/img_w: real image extents (valid uv test)
//   scope:     [x0, x1, y0, y1, z0, z1] rect-frame range gate
//              (cfg.PC_AREA_SCOPE) or nullptr to skip
//
// Writes compacted outputs: rect xyz (k, 3), intensity (k,), uv (k, 2).
// Returns k, the number of surviving points.
int64_t project_and_filter(const float* pts_lidar, int64_t n,
                           const double* v2c_r0, const double* p2,
                           double img_h, double img_w, const double* scope,
                           float* out_rect, float* out_intensity,
                           float* out_uv) {
    int64_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts_lidar + 4 * i;
        const double x = p[0], y = p[1], z = p[2];
        // lidar -> rect (calibration.py:50-58)
        const double rx = v2c_r0[0] * x + v2c_r0[1] * y + v2c_r0[2] * z + v2c_r0[3];
        const double ry = v2c_r0[4] * x + v2c_r0[5] * y + v2c_r0[6] * z + v2c_r0[7];
        const double rz = v2c_r0[8] * x + v2c_r0[9] * y + v2c_r0[10] * z + v2c_r0[11];
        // rect -> image (calibration.py:60-69)
        const double hx = p2[0] * rx + p2[1] * ry + p2[2] * rz + p2[3];
        const double hy = p2[4] * rx + p2[5] * ry + p2[6] * rz + p2[7];
        const double hz = p2[8] * rx + p2[9] * ry + p2[10] * rz + p2[11];
        // the KITTI devkit convention divides by the RECT depth, not the
        // homogeneous w (calibration.py:60-69 uses pts_rect_hom[:, 2])
        const double u = hx / rz;
        const double v = hy / rz;
        const double depth = hz - p2[11];
        // in-image + positive depth (kitti_dataset.py:169-183)
        if (!(u >= 0.0 && u < img_w && v >= 0.0 && v < img_h
              && depth >= 0.0))
            continue;
        if (scope) {
            if (!(rx >= scope[0] && rx <= scope[1]
                  && ry >= scope[2] && ry <= scope[3]
                  && rz >= scope[4] && rz <= scope[5]))
                continue;
        }
        out_rect[3 * k + 0] = (float)rx;
        out_rect[3 * k + 1] = (float)ry;
        out_rect[3 * k + 2] = (float)rz;
        out_intensity[k] = p[3];
        out_uv[2 * k + 0] = (float)u;
        out_uv[2 * k + 1] = (float)v;
        ++k;
    }
    return k;
}

}  // extern "C"
