// K2 and K2s with A stored in bfloat16 (x, y and every output in float32
// or float64, the suffix): the entries of glm_prep.cuh, whose head note
// gives the design. A separate source, so that nvcc builds these
// instances beside glm_prep.cu's rather than after them.
#include "glm_prep.cuh"

SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_bf16_f32, __nv_bfloat16, float, kGGN)
SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_bf16_f64, __nv_bfloat16, double, kGGN)
SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_newton_bf16_f32, __nv_bfloat16, float,
                    kNewton)
SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_newton_bf16_f64, __nv_bfloat16, double,
                    kNewton)
SCSO_GLM_PREP_ENTRY(scso_glm_prep_bf16_f32, __nv_bfloat16, float)
SCSO_GLM_PREP_ENTRY(scso_glm_prep_bf16_f64, __nv_bfloat16, double)

// How many clusters of the cluster form (glm_cluster.cuh) for ``nc``
// candidates and ``group_rows`` rows a group, with ``cluster`` blocks of
// ``threads`` threads and ``smem`` bytes, the card holds at once (into
// *count); the wrapper sizes its grid by it, so that one wave holds it.
extern "C" int scso_glm_prep_cluster_fit(int64_t nc, int64_t group_rows,
                                         int64_t cluster, int64_t threads,
                                         int64_t smem, void* count) {
  int* c = static_cast<int*>(count);
  if (nc == 2)
    return group_rows == 16 ? cl_form::fit<2, 16>(cluster, threads, smem, c)
                            : cl_form::fit<2, 8>(cluster, threads, smem, c);
  return group_rows == 16 ? cl_form::fit<1, 16>(cluster, threads, smem, c)
                          : cl_form::fit<1, 8>(cluster, threads, smem, c);
}
