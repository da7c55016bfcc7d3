// Fused HMC leapfrog trajectory on a GLM posterior, for Hopper (sm_90a): the
// package's library entry points.
//
// Replaces two TPU kernels of mcmc_tpu/ops/fused_logreg.py with one body:
// make_fused_trajectory (kernel body :163-199, pallas_call :215), and
// make_fused_trajectory_rt (kernel body :498-535, pallas_call :551). The
// body at 128 padded columns is fused_glm_body.cuh (its design is described
// there), the cluster body at 256 to 1024 fused_glm_wide_body.cuh; here
// both run the five built-in links, chosen at run time by their code
// (BuiltinLinks). A link traced from torch runs the same bodies from a
// library of its own (mcmc_tpu_torch/ops/_cuda.py: build_link).

#include "fused_glm_body.cuh"

namespace {

// By width, in the open: 128 columns run the warpgroup body
// (fused_glm_body.cuh), every other multiple of 128 up to kMaxDimPadded the
// cluster body (fused_glm_wide_body.cuh, through
// fused_glm_trajectory_wide.cu).
template <bool RT>
int dispatch(const void* z, const void* p, const void* X, const void* y,
             const void* mask, const void* eps_ptr, const void* inv_mass,
             void* z_out, void* p_out, void* u_out, int n_chains, int n_rows,
             int dim_padded, int n_leap, float half_eps, float eps,
             float inv_pv, int link, float nu, void* stream) {
  if (!glm_launch_args_ok(n_chains, n_rows, n_leap) || link < kLogistic ||
      link > kStudentT || (link == kStudentT && !(nu > 0.0f)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim_padded == 128)
    return (int)glm128::launch<BuiltinLinks, RT>(
        z, p, X, y, mask, eps_ptr, inv_mass, z_out, p_out, u_out, n_chains,
        n_rows, n_leap, half_eps, eps, inv_pv, link, nu, s);
  if (dim_padded > 128 && dim_padded <= kMaxDimPadded &&
      dim_padded % 128 == 0)
    return fused_glm_wide_launch(RT, z, p, X, y, mask, eps_ptr, inv_mass,
                                 z_out, p_out, u_out, n_chains, n_rows,
                                 dim_padded, n_leap, half_eps, eps, inv_pv,
                                 link, nu, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch one fused trajectory on `stream`. z, p, z_out, p_out:
// (n_chains, dim_padded) f32; X: (n_rows, dim_padded) bf16; y, mask:
// (n_rows,) f32; u_out: (n_chains,) f32; all contiguous on the device.
// link_param is nu for the Student-t link (link 4). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int fused_glm_trajectory_launch(
    const void* z, const void* p, const void* X, const void* y,
    const void* mask, void* z_out, void* p_out, void* u_out, int n_chains,
    int n_rows, int dim_padded, int n_leap, float half_eps, float eps,
    float inv_pv, int link, float link_param, void* stream) {
  return dispatch<false>(z, p, X, y, mask, nullptr, nullptr, z_out, p_out,
                         u_out, n_chains, n_rows, dim_padded, n_leap, half_eps,
                         eps, inv_pv, link, link_param, stream);
}

// The same with run-time parameters: eps points to one f32 on the device,
// inv_mass to a (dim_padded,) f32 row; the drift is z += eps * (inv_mass * p).
extern "C" int fused_glm_trajectory_rt_launch(
    const void* z, const void* p, const void* X, const void* y,
    const void* mask, void* z_out, void* p_out, void* u_out, const void* eps,
    const void* inv_mass, int n_chains, int n_rows, int dim_padded, int n_leap,
    float inv_pv, int link, float link_param, void* stream) {
  if (eps == nullptr || inv_mass == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(z, p, X, y, mask, eps, inv_mass, z_out, p_out, u_out,
                        n_chains, n_rows, dim_padded, n_leap, 0.0f, 0.0f,
                        inv_pv, link, link_param, stream);
}

extern "C" const char* fused_glm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

