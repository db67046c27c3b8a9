// Native data-plane accelerators for opendwm_tpu_torch (a copy of the JAX
// package's opendwm_tpu/native/data_plane.cpp).
//
// The reference offloads its hot host-side paths to native code (DVGO CUDA
// kernels, zlib inflate inside ZipFile, chamferdist). The device math stays
// in PyTorch and the CUDA kernels of csrc/; THIS file covers the host data
// plane:
//
//  - zip_scan_central_directory: parse a ZIP central directory from a memory
//    buffer into (name, header_offset, compress_type, sizes) records without
//    Python object churn — the czip filesystem's index builder for huge
//    multi-archive datasets (reference caches the same data as .info.json).
//  - inflate_raw: zlib raw-deflate decompression for ZIP_DEFLATED members.
//  - decode_lidar_bin: nuScenes-style float32 .bin (N x stride) → padded
//    (max_points x 3) + count, with optional range filtering; the inner loop
//    of LiDAR batch assembly.
//  - voxelize_points: floor-index BEV occupancy scatter on the host, for
//    dataloader-side voxel precomputation (mirrors ops/voxelize.py).
//
// Exposed with a plain C ABI for ctypes (no pybind11 needed).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// ZIP central directory scan
// ---------------------------------------------------------------------------
// Writes records into caller-provided arrays; returns the number of entries,
// or -1 on error. Names are written packed into name_buf with lengths in
// name_lens.

int64_t zip_scan_central_directory(
    const uint8_t* buf, int64_t size,
    int64_t max_entries,
    int64_t* header_offsets,
    int32_t* compress_types,
    int64_t* compress_sizes,
    int64_t* file_sizes,
    uint8_t* name_buf, int64_t name_buf_capacity,
    int32_t* name_lens) {
  // find End Of Central Directory record (signature 0x06054b50)
  if (size < 22) return -1;
  int64_t eocd = -1;
  int64_t scan_start = size - 22;
  int64_t scan_limit = scan_start > 65557 ? scan_start - 65557 : 0;
  for (int64_t i = scan_start; i >= scan_limit; --i) {
    if (buf[i] == 0x50 && buf[i + 1] == 0x4b && buf[i + 2] == 0x05 &&
        buf[i + 3] == 0x06) {
      eocd = i;
      break;
    }
  }
  if (eocd < 0) return -1;
  uint32_t cd_offset;
  uint16_t total_entries;
  std::memcpy(&total_entries, buf + eocd + 10, 2);
  std::memcpy(&cd_offset, buf + eocd + 16, 4);

  int64_t pos = cd_offset;
  int64_t count = 0;
  int64_t name_pos = 0;
  while (count < max_entries && pos + 46 <= size) {
    uint32_t sig;
    std::memcpy(&sig, buf + pos, 4);
    if (sig != 0x02014b50) break;
    uint16_t method, name_len, extra_len, comment_len;
    uint32_t csize, usize, local_offset;
    std::memcpy(&method, buf + pos + 10, 2);
    std::memcpy(&csize, buf + pos + 20, 4);
    std::memcpy(&usize, buf + pos + 24, 4);
    std::memcpy(&name_len, buf + pos + 28, 2);
    std::memcpy(&extra_len, buf + pos + 30, 2);
    std::memcpy(&comment_len, buf + pos + 32, 2);
    std::memcpy(&local_offset, buf + pos + 42, 4);
    if (name_pos + name_len > name_buf_capacity) return -2;
    std::memcpy(name_buf + name_pos, buf + pos + 46, name_len);
    header_offsets[count] = local_offset;
    compress_types[count] = method;
    compress_sizes[count] = csize;
    file_sizes[count] = usize;
    name_lens[count] = name_len;
    name_pos += name_len;
    pos += 46 + name_len + extra_len + comment_len;
    ++count;
  }
  return count;
}

// ---------------------------------------------------------------------------
// zlib raw inflate (ZIP_DEFLATED member payloads)
// ---------------------------------------------------------------------------
// Returns the decompressed size, or -1 on error.

int64_t inflate_raw(const uint8_t* src, int64_t src_len,
                    uint8_t* dst, int64_t dst_capacity) {
  z_stream strm;
  std::memset(&strm, 0, sizeof(strm));
  if (inflateInit2(&strm, -15) != Z_OK) return -1;
  strm.next_in = const_cast<Bytef*>(src);
  strm.avail_in = static_cast<uInt>(src_len);
  strm.next_out = dst;
  strm.avail_out = static_cast<uInt>(dst_capacity);
  int ret = inflate(&strm, Z_FINISH);
  int64_t produced = static_cast<int64_t>(strm.total_out);
  inflateEnd(&strm);
  if (ret != Z_STREAM_END) return -1;
  return produced;
}

// ---------------------------------------------------------------------------
// LiDAR .bin decode + pad
// ---------------------------------------------------------------------------
// raw: float32 records with `stride` floats each (nuScenes: 5 = x,y,z,i,ring)
// out: (max_points, 3) float32, zero padded. mask: (max_points,) uint8.
// Returns the number of valid points written.

int64_t decode_lidar_bin(
    const uint8_t* raw, int64_t raw_bytes, int32_t stride,
    float x_min, float x_max, float y_min, float y_max,
    float z_min, float z_max, int32_t apply_range_filter,
    int64_t max_points, float* out, uint8_t* mask) {
  const float* pts = reinterpret_cast<const float*>(raw);
  int64_t n = raw_bytes / (static_cast<int64_t>(stride) * 4);
  int64_t written = 0;
  for (int64_t i = 0; i < n && written < max_points; ++i) {
    float x = pts[i * stride + 0];
    float y = pts[i * stride + 1];
    float z = pts[i * stride + 2];
    if (apply_range_filter &&
        (x < x_min || x > x_max || y < y_min || y > y_max || z < z_min ||
         z > z_max))
      continue;
    out[written * 3 + 0] = x;
    out[written * 3 + 1] = y;
    out[written * 3 + 2] = z;
    mask[written] = 1;
    ++written;
  }
  for (int64_t i = written; i < max_points; ++i) {
    out[i * 3 + 0] = 0.f;
    out[i * 3 + 1] = 0.f;
    out[i * 3 + 2] = 0.f;
    mask[i] = 0;
  }
  return written;
}

// ---------------------------------------------------------------------------
// Host-side BEV voxelization (floor-index scatter)
// ---------------------------------------------------------------------------
// points: (n, 3); grid: (D*H*W) float32 zeroed by caller. Matches
// ops/voxelize.py semantics (reference voxelizer.py:24-91).

void voxelize_points(
    const float* points, const uint8_t* mask, int64_t n,
    float x_min, float y_min, float z_min,
    float step, float z_step,
    int64_t depth, int64_t height, int64_t width,
    float* grid) {
  for (int64_t i = 0; i < n; ++i) {
    if (mask && !mask[i]) continue;
    int64_t iw = static_cast<int64_t>(std::floor((points[i * 3] - x_min) / step));
    int64_t ih = static_cast<int64_t>(std::floor((points[i * 3 + 1] - y_min) / step));
    int64_t id = static_cast<int64_t>(std::floor((points[i * 3 + 2] - z_min) / z_step));
    if (iw < 0 || iw >= width || ih < 0 || ih >= height || id < 0 ||
        id >= depth)
      continue;
    grid[(id * height + ih) * width + iw] = 1.0f;
  }
}

}  // extern "C"
