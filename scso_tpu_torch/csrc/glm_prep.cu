// K2 and K2s with A in the compute type (float32 or float64): the
// entries of glm_prep.cuh, whose head note gives the design.
#include "glm_prep.cuh"

SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_f32, float, float, kGGN)
SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_f64, double, double, kGGN)
SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_newton_f32, float, float, kNewton)
SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_newton_f64, double, double, kNewton)
SCSO_GLM_PREP_ENTRY(scso_glm_prep_f32, float, float)
SCSO_GLM_PREP_ENTRY(scso_glm_prep_f64, double, double)
