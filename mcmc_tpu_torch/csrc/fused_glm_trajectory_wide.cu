// Fused HMC leapfrog trajectory on a GLM posterior at dim_padded 256 to
// 1024, for Hopper (sm_90a): the package's library entry of the cluster
// body (fused_glm_wide_body.cuh, whose design is described there) on the
// five built-in links, chosen at run time by their code (BuiltinLinks).
// Replaces the same two TPU kernels as fused_glm_trajectory.cu
// (mcmc_tpu/ops/fused_logreg.py: make_fused_trajectory, pallas_call :215;
// make_fused_trajectory_rt, pallas_call :551) at the widths the 128 body
// cannot hold.

#include "fused_glm_wide_body.cuh"

int fused_glm_wide_launch(bool rt, const void* z, const void* p,
                          const void* X, const void* y, const void* mask,
                          const void* eps_ptr, const void* inv_mass,
                          void* z_out, void* p_out, void* u_out, int n_chains,
                          int n_rows, int dim_padded, int n_leap,
                          float half_eps, float eps, float inv_pv, int link,
                          float nu, cudaStream_t stream) {
  if (dim_padded <= glm_wide::PW || dim_padded > kMaxDimPadded ||
      dim_padded % glm_wide::PW != 0)
    return (int)cudaErrorInvalidValue;
  if (rt)
    return (int)glm_wide::launch<BuiltinLinks, true>(
        z, p, X, y, mask, eps_ptr, inv_mass, z_out, p_out, u_out, n_chains,
        n_rows, dim_padded, n_leap, half_eps, eps, inv_pv, link, nu, stream);
  return (int)glm_wide::launch<BuiltinLinks, false>(
      z, p, X, y, mask, eps_ptr, inv_mass, z_out, p_out, u_out, n_chains,
      n_rows, dim_padded, n_leap, half_eps, eps, inv_pv, link, nu, stream);
}
