// Native PLY codec and Morton-sorted kNN on the host, with a C interface
// that skelsplat_tpu_torch/native.py binds with ctypes and builds with the
// host C++ compiler at first use.
//
// The eval sweep reads thousands of small result clouds: parsing them in
// native code on a thread pool removes the Python loop. The kNN follows
// simple-knn's distCUDA2 (Morton codes over the normalized bounding box,
// sorted boxes of 1024 points, a best-3 scan with box rejection) for large
// point sets, where the brute-force search is quadratic.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Property {
    std::string name;
    int size;        // bytes
    bool is_float;   // f4/f8 vs integer
};

// Minimal binary_little_endian / ascii vertex-element parser.
// Returns 0 on success; fills xyz (3*n floats).
int parse_ply_xyz(const char* path, float* out, int64_t max_pts,
                  int64_t* n_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char line[512];
    if (!fgets(line, sizeof line, f) || strncmp(line, "ply", 3) != 0) {
        fclose(f);
        return -2;
    }
    bool binary = false, ascii = false;
    int64_t n = 0;
    bool in_vertex = false;
    std::vector<Property> props;
    while (fgets(line, sizeof line, f)) {
        if (strncmp(line, "format binary_little_endian", 27) == 0) {
            binary = true;
        } else if (strncmp(line, "format ascii", 12) == 0) {
            ascii = true;
        } else if (strncmp(line, "element vertex", 14) == 0) {
            n = strtoll(line + 14, nullptr, 10);
            in_vertex = true;
        } else if (strncmp(line, "element", 7) == 0) {
            in_vertex = false;
        } else if (strncmp(line, "property", 8) == 0 && in_vertex) {
            char type[32], name[64];
            if (sscanf(line, "property %31s %63s", type, name) == 2) {
                Property p;
                p.name = name;
                if (!strcmp(type, "float") || !strcmp(type, "float32")) {
                    p.size = 4; p.is_float = true;
                } else if (!strcmp(type, "double") ||
                           !strcmp(type, "float64")) {
                    p.size = 8; p.is_float = true;
                } else if (!strcmp(type, "uchar") || !strcmp(type, "char") ||
                           !strcmp(type, "uint8") || !strcmp(type, "int8")) {
                    p.size = 1; p.is_float = false;
                } else if (!strcmp(type, "short") || !strcmp(type, "ushort")) {
                    p.size = 2; p.is_float = false;
                } else if (!strcmp(type, "int") || !strcmp(type, "uint") ||
                           !strcmp(type, "int32") || !strcmp(type, "uint32")) {
                    p.size = 4; p.is_float = false;
                } else {
                    fclose(f);
                    return -3;  // list or unknown property
                }
                props.push_back(p);
            }
        } else if (strncmp(line, "end_header", 10) == 0) {
            break;
        }
    }
    if (n <= 0 || n > max_pts || props.size() < 3) {
        fclose(f);
        return -4;
    }
    int xi = -1, yi = -1, zi = -1;
    int stride = 0;
    std::vector<int> offsets(props.size());
    for (size_t i = 0; i < props.size(); ++i) {
        offsets[i] = stride;
        stride += props[i].size;
        if (props[i].name == "x") xi = (int)i;
        if (props[i].name == "y") yi = (int)i;
        if (props[i].name == "z") zi = (int)i;
    }
    if (xi < 0 || yi < 0 || zi < 0) {
        fclose(f);
        return -5;
    }
    if (binary) {
        std::vector<char> buf((size_t)n * stride);
        if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
            fclose(f);
            return -6;
        }
        auto get = [&](int64_t row, int pi) -> float {
            const char* p = buf.data() + row * stride + offsets[pi];
            if (props[pi].size == 4 && props[pi].is_float) {
                float v;
                memcpy(&v, p, 4);
                return v;
            }
            if (props[pi].size == 8 && props[pi].is_float) {
                double v;
                memcpy(&v, p, 8);
                return (float)v;
            }
            return 0.0f;
        };
        for (int64_t i = 0; i < n; ++i) {
            out[3 * i + 0] = get(i, xi);
            out[3 * i + 1] = get(i, yi);
            out[3 * i + 2] = get(i, zi);
        }
    } else if (ascii) {
        for (int64_t i = 0; i < n; ++i) {
            std::vector<double> vals(props.size());
            for (size_t k = 0; k < props.size(); ++k) {
                if (fscanf(f, "%lf", &vals[k]) != 1) {
                    fclose(f);
                    return -7;
                }
            }
            out[3 * i + 0] = (float)vals[xi];
            out[3 * i + 1] = (float)vals[yi];
            out[3 * i + 2] = (float)vals[zi];
        }
    } else {
        fclose(f);
        return -8;
    }
    fclose(f);
    *n_out = n;
    return 0;
}

}  // namespace

extern "C" {

// Read xyz from one PLY. Returns n (>0) or negative error code.
int64_t skel_read_ply_xyz(const char* path, float* out, int64_t max_pts) {
    int64_t n = 0;
    int rc = parse_ply_xyz(path, out, max_pts, &n);
    return rc == 0 ? n : rc;
}

// Batch-read n_files PLYs with a thread pool. paths: concatenated
// NUL-terminated strings. out: (n_files, max_pts, 3). counts: per-file
// point counts (or negative error codes).
void skel_read_ply_xyz_batch(const char* paths, int64_t n_files,
                             float* out, int64_t max_pts, int64_t* counts,
                             int n_threads) {
    std::vector<const char*> ptrs(n_files);
    const char* p = paths;
    for (int64_t i = 0; i < n_files; ++i) {
        ptrs[i] = p;
        p += strlen(p) + 1;
    }
    if (n_threads <= 0)
        n_threads = (int)std::thread::hardware_concurrency();
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_files) break;
            int64_t n = 0;
            int rc = parse_ply_xyz(ptrs[i], out + i * max_pts * 3,
                                   max_pts, &n);
            counts[i] = rc == 0 ? n : rc;
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

// Morton-sorted mean-squared distance to the 3 nearest neighbors
// (simple-knn's distCUDA2, simple_knn.cu:45-221, CPU edition).
void skel_knn_mean3_sq(const float* pts, int64_t n, float* out) {
    if (n <= 1) {
        for (int64_t i = 0; i < n; ++i) out[i] = 0.0f;
        return;
    }
    float mn[3] = {pts[0], pts[1], pts[2]};
    float mx[3] = {pts[0], pts[1], pts[2]};
    for (int64_t i = 0; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            mn[d] = std::min(mn[d], pts[3 * i + d]);
            mx[d] = std::max(mx[d], pts[3 * i + d]);
        }
    auto expand = [](uint32_t v) {
        uint64_t x = v & 0x3ff;
        x = (x | x << 16) & 0x30000ff;
        x = (x | x << 8) & 0x300f00f;
        x = (x | x << 4) & 0x30c30c3;
        x = (x | x << 2) & 0x9249249;
        return (uint64_t)x;
    };
    std::vector<std::pair<uint64_t, int64_t>> codes(n);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t code = 0;
        for (int d = 0; d < 3; ++d) {
            float span = mx[d] - mn[d];
            float rel = span > 0 ? (pts[3 * i + d] - mn[d]) / span : 0.0f;
            uint32_t q = (uint32_t)(rel * 1023.0f);
            code |= expand(q) << d;
        }
        codes[i] = {code, i};
    }
    std::sort(codes.begin(), codes.end());

    const int64_t BOX = 1024;
    int64_t n_boxes = (n + BOX - 1) / BOX;
    std::vector<float> box_min(n_boxes * 3), box_max(n_boxes * 3);
    for (int64_t b = 0; b < n_boxes; ++b) {
        for (int d = 0; d < 3; ++d) {
            box_min[3 * b + d] = 3.4e38f;
            box_max[3 * b + d] = -3.4e38f;
        }
        for (int64_t i = b * BOX; i < std::min(n, (b + 1) * BOX); ++i) {
            const float* q = pts + 3 * codes[i].second;
            for (int d = 0; d < 3; ++d) {
                box_min[3 * b + d] = std::min(box_min[3 * b + d], q[d]);
                box_max[3 * b + d] = std::max(box_max[3 * b + d], q[d]);
            }
        }
    }
    auto box_dist2 = [&](int64_t b, const float* q) {
        float d2 = 0;
        for (int d = 0; d < 3; ++d) {
            float lo = box_min[3 * b + d], hi = box_max[3 * b + d];
            float diff = q[d] < lo ? lo - q[d] : (q[d] > hi ? q[d] - hi : 0);
            d2 += diff * diff;
        }
        return d2;
    };

    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t ii = next.fetch_add(1);
            if (ii >= n) break;
            int64_t orig = codes[ii].second;
            const float* q = pts + 3 * orig;
            float best[3] = {3.4e38f, 3.4e38f, 3.4e38f};
            // Morton-neighbor pass only PRIMES the box-rejection bound
            // (simple_knn.cu:149-183); the box scan below covers every
            // point, so inserting the primer into `best` would double-count.
            float ub[3] = {3.4e38f, 3.4e38f, 3.4e38f};
            for (int64_t j = std::max<int64_t>(0, ii - 3);
                 j <= std::min(n - 1, ii + 3); ++j) {
                if (j == ii) continue;
                const float* r = pts + 3 * codes[j].second;
                float d2 = 0;
                for (int d = 0; d < 3; ++d) {
                    float t = q[d] - r[d];
                    d2 += t * t;
                }
                if (d2 < ub[2]) {
                    ub[2] = d2;
                    if (ub[2] < ub[1]) std::swap(ub[1], ub[2]);
                    if (ub[1] < ub[0]) std::swap(ub[0], ub[1]);
                }
            }
            for (int64_t b = 0; b < n_boxes; ++b) {
                if (box_dist2(b, q) > std::min(best[2], ub[2])) continue;
                for (int64_t j = b * BOX;
                     j < std::min(n, (b + 1) * BOX); ++j) {
                    if (j == ii) continue;
                    const float* r = pts + 3 * codes[j].second;
                    float d2 = 0;
                    for (int d = 0; d < 3; ++d) {
                        float t = q[d] - r[d];
                        d2 += t * t;
                    }
                    if (d2 < best[2]) {
                        best[2] = d2;
                        if (best[2] < best[1]) std::swap(best[1], best[2]);
                        if (best[1] < best[0]) std::swap(best[0], best[1]);
                    }
                }
            }
            out[orig] = (best[0] + best[1] + best[2]) / 3.0f;
        }
    };
    int n_threads = (int)std::thread::hardware_concurrency();
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

}  // extern "C"
