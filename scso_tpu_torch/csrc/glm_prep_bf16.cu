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
