// The custom op matry::sweep_volume: K1 (csrc/sweep.cu) registered with
// libtorch's dispatcher, so that a program exported with torch.export that
// carries the sweep loads with this one library (torch.ops.load_library)
// and no Python of the port.
//
// Replaces no TPU kernel: it binds K1, which replaces
// matryodshka_tpu/ops/pallas_sweep.py:_sweep_kernel, for exported programs
// (the JAX package's exported StableHLO needs no package to load either).
//
// Three implementations of one schema:
// - CUDA (built with -DMATRY_WITH_CUDA, linked with sweep.cu's object):
//   the checks of ops/sweep.py:sweep_volume, lat/lon as
//   geometry/grids.lat_long_grid builds them, then one launch of K1's C
//   entry matry_sweep on the current stream. Bound and design: sweep.cu.
// - CPU: ops/sweep.py's plain route transcribed into ATen, the same
//   operations in the same order (_preprocess, sweep_inputs,
//   dual_row_params / row_params with cameras.project_ods,
//   ods_sweep_plain), so that it equals the Python plain route bit for bit.
// - Meta: the output's shape and dtype, for FakeTensor mode and
//   torch.export.
//
// matry::sweep_volume_launches() counts the CUDA implementation's launches
// of K1 in this process.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <vector>

#ifdef MATRY_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int matry_sweep(const void* ref, const void* src,
                           const void* depths, const void* intr,
                           const void* lat, const void* lon, void* out,
                           int B, int P, int H, int W, int out_bf16,
                           void* stream);
#endif

namespace {

// math.pi
constexpr double PI = 3.141592653589793;

std::atomic<int64_t> cuda_launches{0};

// geometry/grids.py:lat_long_grid -> (S, T), each [H, W].
std::pair<at::Tensor, at::Tensor> lat_long_grid(int64_t h, int64_t w,
                                                const at::TensorOptions& o) {
  at::Tensor s = at::linspace(-PI + PI / w, PI - PI / w, w, o);
  at::Tensor t = at::linspace(-PI / 2 + PI / (2 * h),
                              PI / 2 - PI / (2 * h), h, o);
  std::vector<at::Tensor> tt = at::meshgrid({t, s}, "ij");
  return {tt[1], tt[0]};
}

// ops/sweep.py:_probe_columns.
std::vector<int64_t> probe_columns(int64_t width) {
  std::vector<int64_t> cols = {0, width / 4, width / 2, (3 * width) / 4};
  for (int64_t k = 0; k < 4; ++k) cols.push_back((2 * k + 1) * width / 8);
  for (int64_t k = 0; k < 8; ++k) cols.push_back((2 * k + 1) * width / 16);
  std::vector<int64_t> out;
  for (int64_t c : cols) {
    c %= width;
    bool seen = false;
    for (int64_t d : out) seen = seen || d == c;
    if (!seen) out.push_back(c);
  }
  return out;
}

// geometry/cameras.py:project_ods (negate_y false) -> [..., 2].
at::Tensor project_ods(const at::Tensor& x, const at::Tensor& y,
                       const at::Tensor& z, int64_t order,
                       const at::Tensor& intrinsics, int64_t width,
                       int64_t height) {
  at::Tensor r = intrinsics.select(0, 0).select(0, 0);
  at::Tensor f = r * r - (x * x + z * z);
  at::Tensor z_larger_x = at::abs(z) > at::abs(x);
  at::Tensor px = at::where(z_larger_x, x, z);
  at::Tensor pz = at::where(z_larger_x, z, x);

  at::Tensor pz_sq = pz * pz;
  at::Tensor a = at::add(px * px / pz_sq, 1.0);
  at::Tensor b = at::mul(f, -2.0) * px / pz_sq;
  at::Tensor c = f + f * f / pz_sq;
  at::Tensor disc = b * b - at::mul(a, 4.0) * c;

  at::Tensor s = at::mul(at::sign(pz), -order) *
                 at::sqrt(at::clamp(disc, 0.0, c10::nullopt));
  s = at::where(z_larger_x, s, -s);

  at::Tensor dx = (-b + s) / at::mul(a, 2.0);
  at::Tensor dz = (f - px * dx) / pz;
  at::Tensor dx2 = at::where(z_larger_x, -dx, -dz);
  at::Tensor dz2 = at::where(z_larger_x, -dz, -dx);

  at::Tensor theta = -at::atan2(dz2, dx2);
  at::Tensor phi = at::atan2(y, at::sqrt(dx2 * dx2 + dz2 * dz2));
  phi = at::where(at::isnan(phi), at::ones_like(phi), phi);
  phi = at::clamp(phi, -PI / 2, PI / 2);

  // grids.py:theta_phi_to_pixels
  at::Tensor u = at::mul(at::div(at::sub(at::add(theta, PI), PI / width),
                                 2 * PI - 2 * PI / width),
                         width - 1);
  at::Tensor v = at::mul(
      at::div(at::sub(at::add(phi, 0.5 * PI), 0.5 * PI / height),
              PI - PI / height),
      height - 1);
  at::Tensor uv = at::stack({u, v}, -1);
  at::Tensor valid = disc >= 0.0;
  return at::where(valid.unsqueeze(-1), uv, at::ones_like(uv));
}

// ops/sweep.py:row_params for one eye and one example's intrinsics [3, 3]:
// y0, y1, fy, x0, fx, valid, each [P, H].
std::vector<at::Tensor> row_params(int64_t order, const at::Tensor& depths,
                                   const at::Tensor& intrinsics,
                                   int64_t height, int64_t width) {
  auto grid = lat_long_grid(
      height, width,
      at::TensorOptions().dtype(depths.scalar_type()).device(depths.device()));
  const at::Tensor& S = grid.first;
  const at::Tensor& T = grid.second;
  std::vector<int64_t> cols = probe_columns(width);
  at::Tensor ci = at::tensor(cols, at::TensorOptions().dtype(at::kLong))
                      .to(depths.device());
  at::Tensor Sc = at::index_select(S, 1, ci);
  at::Tensor Tc = at::index_select(T, 1, ci);
  // cameras.backproject_spherical and grids.spherical_ray_dirs
  at::Tensor cos_t = at::cos(Tc);
  at::Tensor rx = at::cos(Sc) * cos_t;
  at::Tensor ry = at::sin(Tc);
  at::Tensor rz = at::sin(Sc) * cos_t;
  at::Tensor d = depths.unsqueeze(1).unsqueeze(2);
  at::Tensor uv = project_ods(d * rx.unsqueeze(0), d * ry.unsqueeze(0),
                              d * rz.unsqueeze(0), order, intrinsics, width,
                              height);
  at::Tensor uc = uv.select(-1, 0);
  at::Tensor vc = uv.select(-1, 1);
  at::Tensor parked = (uc == 1.0) & (vc == 1.0);
  at::Tensor colv = at::tensor(cols, at::TensorOptions().dtype(at::kLong))
                        .to(uc.scalar_type())
                        .to(uc.device());
  at::Tensor u0c = at::remainder(uc + colv, width);
  at::Tensor idx = at::argmax((~parked).to(at::kInt), -1, true);
  at::Tensor u0 = at::gather(u0c, -1, idx).select(-1, 0);
  at::Tensor v = at::gather(vc, -1, idx).select(-1, 0);

  at::Tensor rho = depths.unsqueeze(1) * at::cos(T.unsqueeze(0).select(2, 0));
  at::Tensor valid = rho >= intrinsics.select(0, 0).select(0, 0);

  at::Tensor y0f = at::floor(v);
  at::Tensor x0f = at::floor(u0);
  at::Tensor y0 = at::remainder(y0f.to(at::kInt), height);
  return {y0.to(at::kInt),
          at::remainder(y0 + 1, height).to(at::kInt),
          v - y0f,
          at::remainder(x0f.to(at::kInt), width).to(at::kInt),
          u0 - x0f,
          valid.to(at::kInt)};
}

// ops/sweep.py:dual_row_params: intrinsics [B, 3, 3] -> six [B, 2, P, H]
// tables (eye 0 = ref, order +1; eye 1 = src, order -1).
std::vector<at::Tensor> dual_row_params(const at::Tensor& depths,
                                        const at::Tensor& intrinsics,
                                        int64_t height, int64_t width) {
  constexpr int N = 6;
  std::vector<std::vector<at::Tensor>> per_b(N);
  for (const at::Tensor& k : intrinsics.unbind(0)) {
    std::vector<at::Tensor> ref = row_params(1, depths, k, height, width);
    std::vector<at::Tensor> src = row_params(-1, depths, k, height, width);
    for (int n = 0; n < N; ++n) {
      per_b[n].push_back(at::stack({ref[n], src[n]}));
    }
  }
  std::vector<at::Tensor> out;
  for (int n = 0; n < N; ++n) out.push_back(at::stack(per_b[n]).contiguous());
  return out;
}

// ops/sweep.py:ods_sweep_plain: images [B, 2, 3, H, W] float32 ->
// [B, 2*P*3, H, W] out_dtype.
at::Tensor ods_sweep_plain(const at::Tensor& images,
                           const std::vector<at::Tensor>& prm,
                           at::ScalarType out_dtype) {
  const at::Tensor &py0 = prm[0], &py1 = prm[1], &pfy = prm[2],
                   &px0 = prm[3], &pfx = prm[4], &pvalid = prm[5];
  const int64_t b = images.size(0), c = images.size(2), h = images.size(3),
                w = images.size(4);
  const int64_t p = py0.size(2);
  at::Tensor j = at::arange(w, at::TensorOptions().device(images.device()));
  at::Tensor xa = at::remainder(px0.to(at::kLong).unsqueeze(-1) - j, w);
  at::Tensor xb = at::remainder(xa + 1, w);
  at::Tensor ya = py0.to(at::kLong).unsqueeze(-1).expand_as(xa);
  at::Tensor yb = py1.to(at::kLong).unsqueeze(-1).expand_as(xa);
  at::Tensor flat = images.to(at::kFloat).reshape({b, 2, c, h * w});

  auto tap = [&](const at::Tensor& y, const at::Tensor& x) {
    at::Tensor idx =
        (y * w + x).reshape({b, 2, 1, -1}).expand({-1, -1, c, -1});
    at::Tensor got = at::gather(flat, 3, idx).reshape({b, 2, c, p, h, w});
    return got.transpose(2, 3);
  };

  // params[...][:, :, :, None, :, None]
  at::Tensor fy = pfy.unsqueeze(3).unsqueeze(5);
  at::Tensor fx = pfx.unsqueeze(3).unsqueeze(5);
  at::Tensor va = at::rsub(fy, 1.0) * tap(ya, xa) + fy * tap(yb, xa);
  at::Tensor vb = at::rsub(fy, 1.0) * tap(ya, xb) + fy * tap(yb, xb);
  at::Tensor out = at::rsub(fx, 1.0) * va + fx * vb;
  at::Tensor park =
      images.unsqueeze(2).slice(4, 1, 2).slice(5, 1, 2).to(at::kFloat);
  at::Tensor valid = pvalid.unsqueeze(3).unsqueeze(5) > 0;
  out = at::where(valid, out, park);
  return out.reshape({b, 2 * p * c, h, w}).to(out_dtype);
}

void check_out_dtype(at::ScalarType out_dtype) {
  TORCH_CHECK_VALUE(out_dtype == at::kFloat || out_dtype == at::kBFloat16,
                    "sweep_volume: out_dtype ", out_dtype);
}

at::Tensor sweep_volume_cpu(const at::Tensor& ref_image,
                            const at::Tensor& src_image,
                            const at::Tensor& depths,
                            const at::Tensor& intrinsics,
                            at::ScalarType out_dtype) {
  TORCH_CHECK_VALUE(ref_image.dim() == 4
                        && src_image.sizes() == ref_image.sizes()
                        && depths.dim() == 1 && intrinsics.dim() == 3,
                    "sweep_volume: ref/src [B, H, W, 3], depths [P], "
                    "intrinsics [B, 3, 3]");
  check_out_dtype(out_dtype);
  // ops/sweep.py:_preprocess and sweep_inputs
  at::Tensor ref = at::sub(at::mul(ref_image, 2.0), 1.0);
  at::Tensor src = at::sub(at::mul(src_image, 2.0), 1.0);
  at::Tensor images = at::stack({ref, src}, 1)
                          .permute({0, 1, 4, 2, 3})
                          .to(at::kFloat)
                          .contiguous();
  return ods_sweep_plain(
      images,
      dual_row_params(depths, intrinsics, ref_image.size(1),
                      ref_image.size(2)),
      out_dtype);
}

at::Tensor sweep_volume_meta(const at::Tensor& ref_image,
                             const at::Tensor& src_image,
                             const at::Tensor& depths,
                             const at::Tensor& intrinsics,
                             at::ScalarType out_dtype) {
  return at::empty_symint({ref_image.sym_size(0), depths.sym_size(0) * 6,
                           ref_image.sym_size(1), ref_image.sym_size(2)},
                          ref_image.options().dtype(out_dtype));
}

#ifdef MATRY_WITH_CUDA
void check_geometry(const at::Tensor& depths, const at::Tensor& intrinsics,
                    int64_t b, const c10::Device& dev) {
  TORCH_CHECK_VALUE(depths.device() == dev
                        && depths.scalar_type() == at::kFloat
                        && depths.dim() == 1 && depths.is_contiguous(),
                    "sweep_volume: depths ", depths.scalar_type(), " ",
                    depths.sizes());
  TORCH_CHECK_VALUE(intrinsics.device() == dev
                        && intrinsics.scalar_type() == at::kFloat
                        && intrinsics.is_contiguous()
                        && intrinsics.sizes() == at::IntArrayRef({b, 3, 3}),
                    "sweep_volume: intrinsics ", intrinsics.scalar_type(),
                    " ", intrinsics.sizes());
}

at::Tensor sweep_volume_cuda(const at::Tensor& ref_image,
                             const at::Tensor& src_image,
                             const at::Tensor& depths,
                             const at::Tensor& intrinsics,
                             at::ScalarType out_dtype) {
  const c10::Device dev = ref_image.device();
  TORCH_CHECK_VALUE(ref_image.dim() == 4, "sweep_volume: ref_image ",
                    ref_image.sizes(), " (contiguous float32 [B, H, W, 3])");
  const int64_t b = ref_image.size(0), h = ref_image.size(1),
                w = ref_image.size(2);
  const int64_t p = depths.dim() == 1 ? depths.size(0) : 0;
  for (const at::Tensor* t : {&ref_image, &src_image}) {
    TORCH_CHECK_VALUE(t->device() == dev && t->scalar_type() == at::kFloat
                          && t->is_contiguous()
                          && t->sizes() == at::IntArrayRef({b, h, w, 3}),
                      "sweep_volume: ", t == &ref_image ? "ref" : "src",
                      "_image ", t->scalar_type(), " ", t->sizes(),
                      " (contiguous float32 [B, H, W, 3])");
  }
  TORCH_CHECK_VALUE(w % 8 == 0, "sweep_volume: width ", w,
                    " is not a multiple of 8");
  check_geometry(depths, intrinsics, b, dev);
  check_out_dtype(out_dtype);
  const c10::cuda::CUDAGuard guard(dev);
  // grids.lat_long_grid's two vectors (grids.lat_long_vectors)
  const auto f32 = at::TensorOptions().dtype(at::kFloat).device(dev);
  at::Tensor lat = at::linspace(-PI / 2 + PI / (2 * h),
                                PI / 2 - PI / (2 * h), h, f32);
  at::Tensor lon = at::linspace(-PI + PI / w, PI - PI / w, w, f32);
  at::Tensor out = at::empty({b, 2 * p * 3, h, w}, f32.dtype(out_dtype));
  const int err = matry_sweep(
      ref_image.data_ptr(), src_image.data_ptr(), depths.data_ptr(),
      intrinsics.data_ptr(), lat.data_ptr(), lon.data_ptr(), out.data_ptr(),
      (int)b, (int)p, (int)h, (int)w, out_dtype == at::kBFloat16,
      c10::cuda::getCurrentCUDAStream(dev.index()).stream());
  TORCH_CHECK(err == 0, "matry_sweep: CUDA launch failed with cudaError_t ",
              err);
  cuda_launches.fetch_add(1);
  return out;
}
#endif

int64_t sweep_volume_launches() { return cuda_launches.load(); }

}  // namespace

TORCH_LIBRARY(matry, m) {
  m.def(
      "sweep_volume(Tensor ref_image, Tensor src_image, Tensor depths, "
      "Tensor intrinsics, ScalarType out_dtype) -> Tensor");
  m.def("sweep_volume_launches() -> int", &sweep_volume_launches);
}

TORCH_LIBRARY_IMPL(matry, CPU, m) {
  m.impl("sweep_volume", &sweep_volume_cpu);
}

TORCH_LIBRARY_IMPL(matry, Meta, m) {
  m.impl("sweep_volume", &sweep_volume_meta);
}

#ifdef MATRY_WITH_CUDA
TORCH_LIBRARY_IMPL(matry, CUDA, m) {
  m.impl("sweep_volume", &sweep_volume_cuda);
}
#endif
