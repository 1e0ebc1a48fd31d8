// Fit kernel K2 of the PyTorch port (fused="onehot"): the fit program of
// fit_program.cuh with K2's per-patch sum, F32Chain (each tile sum added in
// f32 in tile order, the TPU kernel's HIGHEST-precision one-hot dots).
//
// Replaces the TPU Pallas kernel
//   patchworkpp_tpu/ops/pallas/fit_kernel.py:fused_fit
// (body make_fit_kernel, pass program build_pass_program, tile scan
// _seg_scan_sum). The TPU kernel runs the program as 15 unrolled passes;
// each (count, lprsum, fitseed) triple computes what one fused SEEDFIT pass
// does, so this kernel runs the 7 fused passes. The plain PyTorch version is
// patchworkpp_tpu_torch/ops/fit_kernel.py:fused_fit_reference; the two agree
// bit for bit. Its float columns differ from K1's by ulps; its integer
// columns (n, g_count, snapshot gates) and the frame's labels are K1's.

#include "fit_program.cuh"

extern "C" int ppk_fit_onehot(const float* xs, const float* ys, const float* zs,
                              const float* valid, const int* pad_start,
                              const float* gates, const float* consts,
                              const int* prog, int npasses, uint32_t* mask,
                              float* out, int nt, int spad, int out_cols,
                              int snap_off, int carry2_off, int num_lpr,
                              float th_dist_v, float upright_thr, void* stream) {
  return ppk::launch_fit_program<ppk::F32Chain>(
      xs, ys, zs, valid, pad_start, gates, consts, prog, npasses, mask, out, nt, spad,
      out_cols, snap_off, carry2_off, num_lpr, th_dist_v, upright_thr, stream);
}
