// Fit kernel K1 of the PyTorch port (fused=None/"tiled"/"grid"/"grid_iota"):
// the fit program of fit_program.cuh with K1's per-patch sum, Split3 (each
// tile sum's three rne-bf16 parts summed over tiles in f32, the JAX grid
// kernel's movement profile).
//
// Replaces the TPU Pallas kernel
//   patchworkpp_tpu/ops/pallas/fit_kernel_grid.py:fused_fit_grid
// (pass program _pass_config, body make_fit_kernel_grid). The plain PyTorch
// version is patchworkpp_tpu_torch/ops/tiled_fit.py:tiled_fit; the two agree
// bit for bit. Its own library and entry point keep its build and its
// launch count apart from K2's.

#include "fit_program.cuh"

extern "C" int ppk_fit_grid(const float* xs, const float* ys, const float* zs,
                            const float* valid, const int* pad_start,
                            const float* gates, const float* consts,
                            const int* prog, int npasses, uint32_t* mask,
                            float* out, int nt, int spad, int out_cols,
                            int snap_off, int carry2_off, int num_lpr,
                            float th_dist_v, float upright_thr, void* stream) {
  return ppk::launch_fit_program<ppk::Split3>(
      xs, ys, zs, valid, pad_start, gates, consts, prog, npasses, mask, out, nt, spad,
      out_cols, snap_off, carry2_off, num_lpr, th_dist_v, upright_thr, stream);
}
