// TSDF + color + semantic fusion of the visible voxel blocks, in place on
// the block pool, with the per-block min |tsdf| that space carving reads.
//
// Replaces the TPU kernel `ra_slam_tpu/ops/tsdf_pallas.py:tsdf_fuse_pallas`
// (body `_fuse_kernel`). That kernel resolves each voxel's pixel out of a
// 16x16 mip tile with a one-hot matmul, because a flat gather is slow on
// the TPU; here each thread reads its pixel directly from the planar image
// `img6 [6, H*W]` at the flat index `pix` that `map/voxel_map.py:
// integrate_prep` computed (the same pixel the TPU atlas resolves). The
// pool-row gather and scatter that sit outside the TPU kernel are fused in:
// the kernel reads and writes pool row `vis_idx[b]` itself.
//
// Shape: one CTA per visible-block slot, one thread per voxel (512), f32
// throughout; the reference's CUDA integrate kernel has the same shape.
// Slots with vis_mask[b] == 0 are skipped whole: visible_blocks pads them
// with row 0, a live row, so writing them would race with the slot that
// owns row 0. Their minabs is 0, which never releases a block.
//
// What bounds it on the card: device-memory bytes. Per voxel it reads
// 6 x 4 B of pool state (tsdf, weight, prob, rgb x 3), 4 x 4 B of per-voxel
// prep (pix, z, d2r, gate) and 6 image samples, and writes 6 x 4 B; the
// arithmetic (two logs, a log1p, an exp) is small beside that. The image
// reads are scattered (a block's voxels hit a small pixel footprint, so
// they mostly come from L2). Fusing the projection in, coalescing the
// image reads and staging with cp.async are later work.
//
// Operation order follows the TPU kernel and the plain PyTorch version
// (`ops/tsdf_fuse.py:tsdf_fuse_reference`) term for term; it is built
// without --use_fast_math and with -fmad=false, so logf/log1pf/expf and
// the divisions are the IEEE/libdevice ones and no product is contracted
// into an FMA the plain version does not have.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVoxels = 512;  // 8 x 8 x 8 voxels per block
constexpr int kWarps = kVoxels / 32;

__global__ void __launch_bounds__(kVoxels) tsdf_fuse_kernel(
    float* __restrict__ tsdf,            // [N, 512]
    float* __restrict__ weight,          // [N, 512]
    float* __restrict__ prob,            // [N, 512]
    float* __restrict__ rgb,             // [N, 3, 512]
    const int32_t* __restrict__ vis_idx, // [V]
    const uint8_t* __restrict__ vis_mask,// [V] (torch.bool)
    const float* __restrict__ img6,      // [6, hw]: depth r g b ht lt
    int64_t hw,
    const int32_t* __restrict__ pix,     // [V, 512]
    const float* __restrict__ zc,        // [V, 512]
    const float* __restrict__ d2r,       // [V, 512]
    const float* __restrict__ gate,      // [V, 512]
    float* __restrict__ minabs,          // [V]
    float truncation, float max_depth, float max_weight) {
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  if (!vis_mask[b]) {
    if (i == 0) minabs[b] = 0.0f;
    return;
  }
  const int64_t row = vis_idx[b];
  const int64_t v = static_cast<int64_t>(b) * kVoxels + i;
  const int64_t r = row * kVoxels + i;
  const int64_t rc = row * 3 * kVoxels + i;

  const float t_old = tsdf[r];
  const float w_old = weight[r];
  const float p_old = prob[r];
  const float c0 = rgb[rc], c1 = rgb[rc + kVoxels], c2 = rgb[rc + 2 * kVoxels];

  const int64_t p = pix[v];
  const float d = img6[p];
  const float s0 = img6[hw + p], s1 = img6[2 * hw + p], s2 = img6[3 * hw + p];
  const float ht = img6[4 * hw + p], lt = img6[5 * hw + p];
  const float z = zc[v];

  const float sdf = d2r[v] * (d - z);
  const bool update = (gate[v] > 0.0f) && (d > 1e-6f) && (d <= max_depth) &&
                      (sdf > -truncation);

  float t_out = t_old;
  if (update) {
    const float tsdf_obs = fminf(1.0f, sdf / truncation);
    const float w_new = (1.0f - d / max_depth) * 4.0f;
    const float w_comb = w_old + w_new;
    const float inv_w = 1.0f / fmaxf(w_comb, 1e-9f);
    t_out = (t_old * w_old + tsdf_obs * w_new) * inv_w;

    const float p_c = fminf(fmaxf(p_old, 1e-6f), 1.0f - 1e-6f);
    const float lo_old = logf(p_c) - log1pf(-p_c);
    const float lo_obs = logf(fminf(fmaxf(ht, 1e-6f), 1.0f)) -
                         logf(fminf(fmaxf(lt, 1e-6f), 1.0f));
    const float lo_new = (lo_old * w_old + lo_obs * w_new) * inv_w;

    tsdf[r] = t_out;
    weight[r] = fminf(w_comb, max_weight);
    prob[r] = 1.0f / (1.0f + expf(-lo_new));
    rgb[rc] = (c0 * w_old + s0 * w_new) * inv_w;
    rgb[rc + kVoxels] = (c1 * w_old + s1 * w_new) * inv_w;
    rgb[rc + 2 * kVoxels] = (c2 * w_old + s2 * w_new) * inv_w;
  }

  // block min of |t_out|: warp shuffle, then across the 16 warps
  float m = fabsf(t_out);
  for (int off = 16; off > 0; off >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_min[kWarps];
  if ((i & 31) == 0) warp_min[i >> 5] = m;
  __syncthreads();
  if (i < 32) {
    m = warp_min[i < kWarps ? i : 0];  // a repeated entry leaves the min as is
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (i == 0) minabs[b] = m;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tsdf_fuse_launch(
    float* tsdf, float* weight, float* prob, float* rgb,
    const int32_t* vis_idx, const uint8_t* vis_mask,
    const float* img6, int64_t hw,
    const int32_t* pix, const float* zc, const float* d2r, const float* gate,
    float* minabs, int num_slots,
    float truncation, float max_depth, float max_weight, void* stream) {
  if (num_slots > 0) {
    tsdf_fuse_kernel<<<num_slots, kVoxels, 0, static_cast<cudaStream_t>(stream)>>>(
        tsdf, weight, prob, rgb, vis_idx, vis_mask, img6, hw, pix, zc, d2r, gate,
        minabs, truncation, max_depth, max_weight);
  }
  return static_cast<int>(cudaGetLastError());
}
