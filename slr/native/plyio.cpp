// Native IO tier: fast binary PLY writer/reader.
//
// The reference persists clouds with C++ writers (SURVEY.md component 18);
// this is the build's native equivalent for the host-side runtime: a tight
// single-pass binary-little-endian PLY encoder/decoder exposed via a C ABI
// and loaded from Python with ctypes (slr/io/ply.py falls back to a pure
// NumPy path when the shared library is unavailable).
//
// Build: g++ -O3 -shared -fPIC -o libslrio.so plyio.cpp  (slr/native/build.py)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Write a binary_little_endian PLY with float xyz (+ optional uchar rgb,
// optional float nx/ny/nz). Returns 0 on success.
int slr_write_ply(const char* path, int64_t n, const float* xyz,
                  const uint8_t* rgb, const float* normals) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  std::string header = "ply\nformat binary_little_endian 1.0\n";
  header += "comment slr structured-light engine\n";
  header += "element vertex " + std::to_string(n) + "\n";
  header += "property float x\nproperty float y\nproperty float z\n";
  if (normals)
    header += "property float nx\nproperty float ny\nproperty float nz\n";
  if (rgb)
    header +=
        "property uchar red\nproperty uchar green\nproperty uchar blue\n";
  header += "end_header\n";
  if (fwrite(header.data(), 1, header.size(), f) != header.size()) {
    fclose(f);
    return 2;
  }
  // interleave row-wise into a buffer for one big write
  const size_t stride = 12 + (normals ? 12 : 0) + (rgb ? 3 : 0);
  std::vector<uint8_t> buf(static_cast<size_t>(n) * stride);
  uint8_t* p = buf.data();
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(p, xyz + 3 * i, 12);
    p += 12;
    if (normals) {
      std::memcpy(p, normals + 3 * i, 12);
      p += 12;
    }
    if (rgb) {
      std::memcpy(p, rgb + 3 * i, 3);
      p += 3;
    }
  }
  size_t wrote = fwrite(buf.data(), 1, buf.size(), f);
  fclose(f);
  return wrote == buf.size() ? 0 : 3;
}

// Probe a PLY: returns vertex count, sets *has_rgb / *has_normals.
// Only supports the layout slr_write_ply produces (x y z [n] [rgb]).
int64_t slr_ply_info(const char* path, int* has_rgb, int* has_normals) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  int64_t n = -1;
  *has_rgb = 0;
  *has_normals = 0;
  while (fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "element vertex", 14) == 0)
      n = std::strtoll(line + 14, nullptr, 10);
    else if (std::strncmp(line, "property float nx", 17) == 0)
      *has_normals = 1;
    else if (std::strncmp(line, "property uchar red", 18) == 0)
      *has_rgb = 1;
    else if (std::strncmp(line, "end_header", 10) == 0)
      break;
  }
  fclose(f);
  return n;
}

int slr_read_ply(const char* path, int64_t n, float* xyz, uint8_t* rgb,
                 float* normals) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  char line[512];
  int has_rgb = 0, has_norm = 0;
  while (fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "property float nx", 17) == 0) has_norm = 1;
    if (std::strncmp(line, "property uchar red", 18) == 0) has_rgb = 1;
    if (std::strncmp(line, "end_header", 10) == 0) break;
  }
  const size_t stride = 12 + (has_norm ? 12 : 0) + (has_rgb ? 3 : 0);
  std::vector<uint8_t> buf(static_cast<size_t>(n) * stride);
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return 2;
  }
  fclose(f);
  const uint8_t* p = buf.data();
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(xyz + 3 * i, p, 12);
    p += 12;
    if (has_norm) {
      if (normals) std::memcpy(normals + 3 * i, p, 12);
      p += 12;
    }
    if (has_rgb) {
      if (rgb) std::memcpy(rgb + 3 * i, p, 3);
      p += 3;
    }
  }
  return 0;
}

}  // extern "C"
