// Fused HMC leapfrog trajectory on a GLM posterior past 1024 padded
// columns, for Hopper (sm_90a): the package's library entries of the
// two-pass body (fused_glm_xwide_body.cuh, whose design is described there)
// on the five built-in links, one instantiation a link, chosen at launch
// by their code (glm_xwide::launch_builtin). Replaces the same two TPU
// kernels as fused_glm_trajectory.cu (mcmc_tpu/ops/fused_logreg.py:
// make_fused_trajectory, pallas_call :215; make_fused_trajectory_rt,
// pallas_call :551) at the widths the cluster body cannot hold. The
// caller allocates the body's workspace, fused_glm_xwide_workspace_bytes
// bytes on the device.

#include "fused_glm_xwide_body.cuh"

namespace {

template <bool RT>
int xwide_dispatch(const void* z, const void* p, const void* X, const void* y,
                   const void* mask, const void* eps_ptr,
                   const void* inv_mass, void* z_out, void* p_out, void* u_out,
                   void* work, int n_chains, int n_rows, int dim_padded,
                   int n_leap, float half_eps, float eps, float inv_pv,
                   int link, float nu, void* stream) {
  if (!glm_launch_args_ok(n_chains, n_rows, n_leap) || link < kLogistic ||
      link > kStudentT || (link == kStudentT && !(nu > 0.0f)) ||
      dim_padded <= kMaxDimPadded || dim_padded % glm_xwide::PW != 0)
    return (int)cudaErrorInvalidValue;
  return (int)glm_xwide::launch_builtin<RT>(
      z, p, X, y, mask, eps_ptr, inv_mass, z_out, p_out, u_out, work,
      n_chains, n_rows, dim_padded, n_leap, half_eps, eps, inv_pv, link, nu,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// The workspace of a launch at these sizes, in bytes.
extern "C" long long fused_glm_xwide_workspace_bytes(int n_chains, int n_rows,
                                                     int dim_padded) {
  return (long long)glm_xwide::workspace_bytes(n_chains, n_rows, dim_padded);
}

// fused_glm_trajectory_launch's arguments for dim_padded a multiple of 128
// past 1024, and `work`, the workspace on the device.
extern "C" int fused_glm_xwide_trajectory_launch(
    const void* z, const void* p, const void* X, const void* y,
    const void* mask, void* z_out, void* p_out, void* u_out, int n_chains,
    int n_rows, int dim_padded, int n_leap, float half_eps, float eps,
    float inv_pv, int link, float link_param, void* work, void* stream) {
  return xwide_dispatch<false>(z, p, X, y, mask, nullptr, nullptr, z_out,
                               p_out, u_out, work, n_chains, n_rows,
                               dim_padded, n_leap, half_eps, eps, inv_pv, link,
                               link_param, stream);
}

// The same with run-time parameters (fused_glm_trajectory_rt_launch's).
extern "C" int fused_glm_xwide_trajectory_rt_launch(
    const void* z, const void* p, const void* X, const void* y,
    const void* mask, void* z_out, void* p_out, void* u_out, const void* eps,
    const void* inv_mass, int n_chains, int n_rows, int dim_padded, int n_leap,
    float inv_pv, int link, float link_param, void* work, void* stream) {
  if (eps == nullptr || inv_mass == nullptr) return (int)cudaErrorInvalidValue;
  return xwide_dispatch<true>(z, p, X, y, mask, eps, inv_mass, z_out, p_out,
                              u_out, work, n_chains, n_rows, dim_padded,
                              n_leap, 0.0f, 0.0f, inv_pv, link, link_param,
                              stream);
}
