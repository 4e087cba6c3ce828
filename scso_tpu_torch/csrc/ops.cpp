// K1–K5 as PyTorch custom ops in the namespace ``scso``, so that
// torch.export can hold them in a program (utils/deploy.py) and a
// process that has never imported scso_tpu_torch can run that program
// after torch.ops.load_library of this library.
//
// Each op has a Meta function (its outputs' shapes, for tracing) and a
// CUDA implementation that allocates its outputs and scratch and calls
// the kernel's plain C entry point (csrc/*.cu, linked into this same
// library) on the current stream of the operands' card. Every launch
// geometry (K1's blocks and row groups, K2's PrepGrid, K3's UpdateForm,
// K4's TwoLoopPlan, K5's MglmGrid) is computed in Python when the
// program is traced and comes in as int arguments: shapes are static in
// a program, so the C++ stays thin.
//
// Built with g++ against torch's headers (no CUDA header: the stream
// comes through c10's device-generic interface) and linked with the
// kernels' objects by ops/cuda/build.py. -DSCSO_OPS_META_ONLY builds the
// schemas and Meta functions alone (no kernel to link): the CPU tests'
// build.

#include <torch/library.h>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <c10/util/Exception.h>

#include <cstdint>
#include <optional>
#include <string>
#include <tuple>
#include <vector>

namespace {

using at::Tensor;
template <class T>
using optional = std::optional<T>;

// ---------------------------------------------------------------------
// shapes (Meta) — shared by the CUDA implementations
// ---------------------------------------------------------------------

Tensor like(const Tensor& t, at::IntArrayRef sizes) {
  return at::empty(sizes, t.options());
}

// K2's grid list: form (0 one-pass, 1 cluster, 2 wide, 3 split), then
// the C entry's blocks, rows_per_block, smem, threads, chunks_per_thread,
// row_blocks, cluster, stages, group_rows
constexpr int kGridLen = 10;
bool two_pass(at::IntArrayRef grid) { return grid[0] >= 2; }

void check_grid(at::IntArrayRef grid) {
  TORCH_CHECK(grid.size() == kGridLen, "scso: a prep grid has ", kGridLen,
              " ints, got ", grid.size());
}

Tensor normal_matvec_meta(const Tensor& A, const Tensor& w, const Tensor& v,
                          int64_t blocks, int64_t wide, int64_t groups) {
  return like(v, {A.size(1)});
}

using Pair = std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                        Tensor, Tensor, Tensor>;

Pair glm_prep_pair_meta(const Tensor& A, const Tensor& y, const Tensor& xt,
                        const Tensor& xd, const optional<Tensor>& rw,
                        const optional<Tensor>& wt, const optional<Tensor>& wd,
                        int64_t m_norm, int64_t kind, int64_t newton,
                        at::IntArrayRef grid, int64_t phase) {
  check_grid(grid);
  const int64_t m = A.size(0), n = A.size(1);
  return {like(xt, {m}), like(xt, {m}), like(xt, {n}), like(xt, {n}),
          like(xt, {n}), like(xt, {n}), like(xt, {}),  like(xt, {}),
          like(xt, {two_pass(grid) ? 2 : 0, m})};
}

using Single = std::tuple<Tensor, Tensor, Tensor, Tensor>;

Single glm_prep_meta(const Tensor& A, const Tensor& y, const Tensor& x,
                     const optional<Tensor>& rw, const optional<Tensor>& w,
                     int64_t m_norm, int64_t kind, at::IntArrayRef grid,
                     int64_t phase) {
  check_grid(grid);
  const int64_t m = A.size(0), n = A.size(1);
  return {like(x, {m}), like(x, {n}), like(x, {n}),
          like(x, {two_pass(grid) ? 1 : 0, m})};
}

std::tuple<Tensor, Tensor> score_update_meta(
    const Tensor& x, const Tensor& d, const Tensor& lgr, const Tensor& hr,
    const optional<Tensor>& lb, const optional<Tensor>& ub, const Tensor& lam,
    const Tensor& ss, const Tensor& Mg, int64_t reg, int64_t blocks,
    int64_t chunk, int64_t grid) {
  return {like(x, x.sizes()), like(x, {3})};
}

Tensor two_loop_meta(const Tensor& S, const Tensor& Y, const Tensor& g,
                     const Tensor& pos, const Tensor& count, const Tensor& H0,
                     int64_t blocks, int64_t chunk, int64_t flags,
                     int64_t smem) {
  return like(g, g.sizes());
}

// K5's forms: 0 two-pass, 1 tensor cores, 2 the split form's rows pass
// (U = A·V into qu), 3 its columns pass (Aᵀ·qu). V comes transposed, (k,
// p), for all but the tensor-core form
std::tuple<Tensor, Tensor> mglm_matvec_meta(const Tensor& A, const Tensor& Z,
                                            const Tensor& V,
                                            const optional<Tensor>& qu,
                                            int64_t blocks,
                                            int64_t rows_per_block,
                                            int64_t form) {
  const int64_t m = A.size(0), p = A.size(1), k = Z.size(1);
  return {like(V, {p, k}), like(V, {form == 1 ? 0 : m, k})};
}

#ifndef SCSO_OPS_META_ONLY

// ---------------------------------------------------------------------
// the kernels' C entry points (csrc/*.cu)
// ---------------------------------------------------------------------

#define I64 int64_t
#define CP const void*
#define P void*
extern "C" {
#define SCSO_K1(NAME) int NAME(CP, CP, CP, P, P, I64, I64, I64, I64, I64, P);
SCSO_K1(scso_normal_matvec_f32)
SCSO_K1(scso_normal_matvec_f64)
SCSO_K1(scso_normal_matvec_bf16_f32)
SCSO_K1(scso_normal_matvec_bf16_f64)
#define SCSO_K2(NAME)                                                        \
  int NAME(CP, CP, CP, CP, P, P, P, P, P, P, P, P, P, P, P, I64, I64, I64,  \
           I64, I64, I64, I64, I64, I64, I64, I64, I64, I64, I64, P);
#define SCSO_K2_ALL(BASE) \
  SCSO_K2(BASE##_f32) SCSO_K2(BASE##_f64) SCSO_K2(BASE##_bf16_f32) \
  SCSO_K2(BASE##_bf16_f64)
SCSO_K2_ALL(scso_glm_prep_pair)
SCSO_K2_ALL(scso_glm_prep_pair_newton)
#define SCSO_K2S(NAME)                                                     \
  int NAME(CP, CP, CP, P, P, P, P, P, I64, I64, I64, I64, I64, I64, I64,  \
           I64, I64, I64, I64, I64, I64, I64, P);
SCSO_K2S(scso_glm_prep_f32)
SCSO_K2S(scso_glm_prep_f64)
SCSO_K2S(scso_glm_prep_bf16_f32)
SCSO_K2S(scso_glm_prep_bf16_f64)
#define SCSO_K3(NAME)                                                       \
  int NAME(CP, CP, CP, CP, CP, CP, CP, CP, CP, I64, P, P, P, I64, I64, I64, \
           I64, P);
SCSO_K3(scso_score_update_f32)
SCSO_K3(scso_score_update_f64)
#define SCSO_K4(NAME) \
  int NAME(CP, CP, CP, CP, CP, CP, P, P, I64, I64, I64, I64, I64, I64, P);
SCSO_K4(scso_two_loop_f32)
SCSO_K4(scso_two_loop_f64)
#define SCSO_K5(NAME) \
  int NAME(CP, CP, CP, P, P, P, I64, I64, I64, I64, I64, I64, P);
SCSO_K5(scso_mglm_matvec_f32)
SCSO_K5(scso_mglm_matvec_f64)
SCSO_K5(scso_mglm_matvec_bf16_f32)
SCSO_K5(scso_mglm_matvec_bf16_f64)
const char* scso_cuda_error_string(int code);
}

// ---------------------------------------------------------------------
// CUDA implementations
// ---------------------------------------------------------------------

void* stream_of(const Tensor& t) {
  return c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)
      ->getStream(t.device())
      .native_handle();
}

void check(int rc, const char* what) {
  TORCH_CHECK(rc == 0, "scso::", what, ": CUDA error ", rc, " at launch: ",
              scso_cuda_error_string(rc));
}

bool is_f64(const Tensor& t) {
  TORCH_CHECK(t.scalar_type() == at::kFloat || t.scalar_type() == at::kDouble,
              "scso: the compute dtype is float32 or float64, got ",
              t.scalar_type());
  return t.scalar_type() == at::kDouble;
}

bool narrow(const Tensor& A) { return A.scalar_type() == at::kBFloat16; }

CP cptr(const optional<Tensor>& t) {
  return t.has_value() ? t->data_ptr() : nullptr;
}

Tensor normal_matvec_cuda(const Tensor& A, const Tensor& w, const Tensor& v,
                          int64_t blocks, int64_t wide, int64_t groups) {
  c10::DeviceGuard guard(A.device());
  const int64_t m = A.size(0), n = A.size(1);
  Tensor out = like(v, {n});
  Tensor partials = like(v, {blocks, n});
  auto fn = narrow(A) ? (is_f64(v) ? scso_normal_matvec_bf16_f64
                                   : scso_normal_matvec_bf16_f32)
                      : (is_f64(v) ? scso_normal_matvec_f64
                                   : scso_normal_matvec_f32);
  check(fn(A.data_ptr(), w.data_ptr(), v.data_ptr(), partials.data_ptr(),
           out.data_ptr(), m, n, blocks, wide, groups, stream_of(A)),
        "normal_matvec");
  return out;
}

// K2's scratch: the blocks' partials (in the compute type one-pass and
// cluster, in double for the two passes) and the loss partials
Tensor partials_of(const Tensor& x, at::IntArrayRef grid, int64_t cand,
                   int64_t n) {
  auto opts = x.options();
  if (two_pass(grid)) opts = opts.dtype(at::kDouble);
  return at::empty({grid[1] * 2 * cand * n}, opts);
}

Pair glm_prep_pair_cuda(const Tensor& A, const Tensor& y, const Tensor& xt,
                        const Tensor& xd, const optional<Tensor>& rw_in,
                        const optional<Tensor>& wt_in,
                        const optional<Tensor>& wd_in, int64_t m_norm,
                        int64_t kind, int64_t newton, at::IntArrayRef grid,
                        int64_t phase) {
  c10::DeviceGuard guard(A.device());
  auto [wt, wd, bt, bd, ht, hd, lt, ld, rw] = glm_prep_pair_meta(
      A, y, xt, xd, rw_in, wt_in, wd_in, m_norm, kind, newton, grid, phase);
  if (phase == 2) {  // the split form's columns pass reads ρ and w
    TORCH_CHECK(rw_in.has_value() && wt_in.has_value() && wd_in.has_value(),
                "scso::glm_prep_pair: phase 2 takes rw, w_t and w_d");
    rw.copy_(*rw_in);
    wt.copy_(*wt_in);
    wd.copy_(*wd_in);
  }
  const int64_t m = A.size(0), n = A.size(1);
  Tensor partials = partials_of(xt, grid, 2, n);
  Tensor loss_partials = at::empty({grid[6] * 2}, xt.options().dtype(at::kDouble));
  const bool f64 = is_f64(xt), bf = narrow(A);
  auto fn = newton
      ? (bf ? (f64 ? scso_glm_prep_pair_newton_bf16_f64
                   : scso_glm_prep_pair_newton_bf16_f32)
            : (f64 ? scso_glm_prep_pair_newton_f64
                   : scso_glm_prep_pair_newton_f32))
      : (bf ? (f64 ? scso_glm_prep_pair_bf16_f64 : scso_glm_prep_pair_bf16_f32)
            : (f64 ? scso_glm_prep_pair_f64 : scso_glm_prep_pair_f32));
  check(fn(A.data_ptr(), y.data_ptr(), xt.data_ptr(), xd.data_ptr(),
           wt.data_ptr(), wd.data_ptr(), two_pass(grid) ? rw.data_ptr() : nullptr,
           bt.data_ptr(), bd.data_ptr(), ht.data_ptr(), hd.data_ptr(),
           lt.data_ptr(), ld.data_ptr(), partials.data_ptr(),
           loss_partials.data_ptr(), m, n, m_norm, kind, grid[1], grid[2],
           grid[3], grid[4], grid[5], grid[6], grid[7], grid[8], grid[9],
           phase, stream_of(A)),
        "glm_prep_pair");
  return {wt, wd, bt, bd, ht, hd, lt, ld, rw};
}

Single glm_prep_cuda(const Tensor& A, const Tensor& y, const Tensor& x,
                     const optional<Tensor>& rw_in, const optional<Tensor>& w_in,
                     int64_t m_norm, int64_t kind, at::IntArrayRef grid,
                     int64_t phase) {
  c10::DeviceGuard guard(A.device());
  auto [w, b, hd, rw] =
      glm_prep_meta(A, y, x, rw_in, w_in, m_norm, kind, grid, phase);
  if (phase == 2) {
    TORCH_CHECK(rw_in.has_value() && w_in.has_value(),
                "scso::glm_prep: phase 2 takes rw and w");
    rw.copy_(*rw_in);
    w.copy_(*w_in);
  }
  const int64_t m = A.size(0), n = A.size(1);
  Tensor partials = partials_of(x, grid, 1, n);
  const bool f64 = is_f64(x), bf = narrow(A);
  auto fn = bf ? (f64 ? scso_glm_prep_bf16_f64 : scso_glm_prep_bf16_f32)
               : (f64 ? scso_glm_prep_f64 : scso_glm_prep_f32);
  check(fn(A.data_ptr(), y.data_ptr(), x.data_ptr(), w.data_ptr(),
           two_pass(grid) ? rw.data_ptr() : nullptr, b.data_ptr(),
           hd.data_ptr(), partials.data_ptr(), m, n, m_norm, kind, grid[1],
           grid[2], grid[3], grid[4], grid[5], grid[6], grid[7], grid[8],
           grid[9], phase, stream_of(A)),
        "glm_prep");
  return {w, b, hd, rw};
}

std::tuple<Tensor, Tensor> score_update_cuda(
    const Tensor& x, const Tensor& d, const Tensor& lgr, const Tensor& hr,
    const optional<Tensor>& lb, const optional<Tensor>& ub, const Tensor& lam,
    const Tensor& ss, const Tensor& Mg, int64_t reg, int64_t blocks,
    int64_t chunk, int64_t grid) {
  c10::DeviceGuard guard(x.device());
  Tensor x_new = like(x, x.sizes());
  Tensor stats = like(x, {3});
  Tensor partials =
      at::empty({grid ? 2 * blocks : 0}, x.options().dtype(at::kDouble));
  auto fn = is_f64(x) ? scso_score_update_f64 : scso_score_update_f32;
  check(fn(x.data_ptr(), d.data_ptr(), lgr.data_ptr(), hr.data_ptr(),
           cptr(lb), cptr(ub), lam.data_ptr(), ss.data_ptr(), Mg.data_ptr(),
           reg, x_new.data_ptr(), stats.data_ptr(),
           grid ? partials.data_ptr() : nullptr, x.size(0), blocks, chunk,
           grid, stream_of(x)),
        "score_update");
  return {x_new, stats};
}

constexpr int64_t kAlphaInSmem = 1;  // two_loop.cu's flag

Tensor two_loop_cuda(const Tensor& S, const Tensor& Y, const Tensor& g,
                     const Tensor& pos, const Tensor& count, const Tensor& H0,
                     int64_t blocks, int64_t chunk, int64_t flags,
                     int64_t smem) {
  c10::DeviceGuard guard(g.device());
  const int64_t m = S.size(0), n = S.size(1);
  Tensor out = like(g, g.sizes());
  Tensor scratch = like(g, {(flags & kAlphaInSmem) ? 0 : blocks * 2 * m});
  auto fn = is_f64(g) ? scso_two_loop_f64 : scso_two_loop_f32;
  check(fn(S.data_ptr(), Y.data_ptr(), g.data_ptr(), pos.data_ptr(),
           count.data_ptr(), H0.data_ptr(),
           (flags & kAlphaInSmem) ? nullptr : scratch.data_ptr(),
           out.data_ptr(), m, n, blocks, chunk, flags, smem, stream_of(g)),
        "two_loop");
  return out;
}

std::tuple<Tensor, Tensor> mglm_matvec_cuda(const Tensor& A, const Tensor& Z,
                                            const Tensor& V,
                                            const optional<Tensor>& qu_in,
                                            int64_t blocks,
                                            int64_t rows_per_block,
                                            int64_t form) {
  c10::DeviceGuard guard(A.device());
  auto [out, qu] =
      mglm_matvec_meta(A, Z, V, qu_in, blocks, rows_per_block, form);
  if (form == 3) {
    TORCH_CHECK(qu_in.has_value(), "scso::mglm_matvec: form 3 takes qu");
    qu.copy_(*qu_in);
  }
  const int64_t m = A.size(0), p = A.size(1), k = Z.size(1);
  Tensor partials = like(V, {blocks, p * k});
  const bool f64 = is_f64(V), bf = narrow(A);
  auto fn = bf ? (f64 ? scso_mglm_matvec_bf16_f64 : scso_mglm_matvec_bf16_f32)
               : (f64 ? scso_mglm_matvec_f64 : scso_mglm_matvec_f32);
  check(fn(A.data_ptr(), Z.data_ptr(), V.data_ptr(),
           form == 1 ? nullptr : qu.data_ptr(), partials.data_ptr(),
           out.data_ptr(), m, p, k, blocks, rows_per_block, form,
           stream_of(A)),
        "mglm_matvec");
  return {out, qu};
}

#endif  // SCSO_OPS_META_ONLY

}  // namespace

TORCH_LIBRARY(scso, m) {
  m.def("normal_matvec(Tensor A, Tensor w, Tensor v, int blocks, int wide, "
        "int groups) -> Tensor");
  m.def("glm_prep_pair(Tensor A, Tensor y, Tensor x_t, Tensor x_d, "
        "Tensor? rw, Tensor? w_t, Tensor? w_d, int m_norm, int kind, "
        "int newton, int[] grid, int phase) -> (Tensor, Tensor, Tensor, "
        "Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("glm_prep(Tensor A, Tensor y, Tensor x, Tensor? rw, Tensor? w, "
        "int m_norm, int kind, int[] grid, int phase) -> (Tensor, Tensor, "
        "Tensor, Tensor)");
  m.def("score_update(Tensor x, Tensor d, Tensor lgr, Tensor hr, Tensor? lb, "
        "Tensor? ub, Tensor lam, Tensor ss, Tensor Mg, int reg, int blocks, "
        "int chunk, int grid) -> (Tensor, Tensor)");
  m.def("two_loop(Tensor S, Tensor Y, Tensor g, Tensor pos, Tensor count, "
        "Tensor H0, int blocks, int chunk, int flags, int smem) -> Tensor");
  m.def("mglm_matvec(Tensor A, Tensor Z, Tensor V, Tensor? qu, int blocks, "
        "int rows_per_block, int form) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(scso, Meta, m) {
  m.impl("normal_matvec", &normal_matvec_meta);
  m.impl("glm_prep_pair", &glm_prep_pair_meta);
  m.impl("glm_prep", &glm_prep_meta);
  m.impl("score_update", &score_update_meta);
  m.impl("two_loop", &two_loop_meta);
  m.impl("mglm_matvec", &mglm_matvec_meta);
}

#ifndef SCSO_OPS_META_ONLY
TORCH_LIBRARY_IMPL(scso, CUDA, m) {
  m.impl("normal_matvec", &normal_matvec_cuda);
  m.impl("glm_prep_pair", &glm_prep_pair_cuda);
  m.impl("glm_prep", &glm_prep_cuda);
  m.impl("score_update", &score_update_cuda);
  m.impl("two_loop", &two_loop_cuda);
  m.impl("mglm_matvec", &mglm_matvec_cuda);
}
#endif
