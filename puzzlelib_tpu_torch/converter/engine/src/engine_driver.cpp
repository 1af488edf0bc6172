// Native serving host driver over libtorch.
//
// Counterpart of puzzlelib_tpu/converter/engine/src/pjrt_driver.cpp: a
// standalone C++ program that runs an engine that
// puzzlelib_tpu_torch.converter.engine.buildEngine saved, without a Python
// interpreter in the serving path.  It reads the engine's program
// (<name>.<dtype>.program, the exported graph as text; its format is in
// converter/engine/program.py) and its weights (<name>.<dtype>.weights),
// and walks the nodes in order, each one a boxed call through the
// dispatcher with the schema's defaults filled in: the same aten kernels
// that Engine's GraphModule reaches, on the same arguments.
//
// The four custom operators of the hand kernels are registered here in C++
// (TORCH_LIBRARY(puzzlelib)), with the schemas that torch.library.custom_op
// records in Python: on CUDA tensors they do what the Python wrappers do and
// launch the kernels' C entries (csrc/matmul.cu, winograd.cu, flash.cu) on
// the current stream; on CPU tensors they run C++ ports of the wrappers'
// plain versions, built from the same aten ops in the same order.  These
// registrations live only in this program: loaded into a Python process they
// would clash with the custom_ops of the same names.
//
// Usage:
//   engine_driver [--runs N] <device: cuda|cpu> <program> <output.npy> [input1.npy ...]
//
// f32 in, f32 out.  On stderr: "wrote <output>" and one "report" line, a JSON
// object with the launches and calls of each custom operator, the program's
// load time and each run's time (synchronised).  A missing operator, a
// malformed line, a failed launch or a device other than the program's
// ends the run with exit code 1 and a message; nothing falls back.

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <ATen/core/stack.h>
#include <c10/core/InferenceMode.h>
#include <torch/library.h>

#ifdef PL_WITH_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

#include <cerrno>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <optional>
#include <sstream>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

#include "routes.h"

namespace {

struct DriverError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string &msg) { throw DriverError(msg); }

// -- the custom operators' counters: calls, and the kernel launches among them (the nodes run one
// at a time, on one thread) --------------------------------------------------------------------

const char *const OPERATORS[] = {"matmul", "matmul_nt", "winograd_conv2d", "flash"};

std::map<std::string, long long> calls, launches;

// -- minimal .npy v1 I/O (float32, C order), as the PJRT driver's ---------------------------------

struct NpyArray {
    std::vector<int64_t> dims;
    std::vector<float> data;
};

NpyArray loadNpy(const std::string &path)
{
    std::ifstream file(path, std::ios::binary);
    if (!file)
        fail("cannot open " + path);

    char magic[6];
    file.read(magic, 6);
    if (!file || std::memcmp(magic, "\x93NUMPY", 6) != 0)
        fail(path + " is not a .npy file");

    unsigned char version[2];
    file.read(reinterpret_cast<char *>(version), 2);

    uint32_t headerLen = 0;
    if (version[0] == 1) {
        uint16_t len16;
        file.read(reinterpret_cast<char *>(&len16), 2);
        headerLen = len16;
    } else {
        file.read(reinterpret_cast<char *>(&headerLen), 4);
    }

    std::string header(headerLen, '\0');
    file.read(header.data(), headerLen);

    if (header.find("'descr': '<f4'") == std::string::npos && header.find("'descr':'<f4'") == std::string::npos)
        fail(path + ": only float32 ('<f4') arrays are supported");
    if (header.find("'fortran_order': False") == std::string::npos)
        fail(path + ": fortran-order arrays are not supported");

    NpyArray out;

    size_t shapePos = header.find("'shape': (");
    if (shapePos == std::string::npos)
        fail(path + ": cannot locate shape in npy header");

    size_t pos = shapePos + 10;
    while (pos < header.size() && header[pos] != ')') {
        while (pos < header.size() && !isdigit(header[pos]) && header[pos] != ')')
            ++pos;
        if (pos >= header.size() || header[pos] == ')')
            break;

        int64_t dim = 0;
        while (pos < header.size() && isdigit(header[pos])) {
            dim = dim * 10 + (header[pos] - '0');
            ++pos;
        }
        out.dims.push_back(dim);
    }

    int64_t count = 1;
    for (int64_t d : out.dims)
        count *= d;

    out.data.resize(count);
    file.read(reinterpret_cast<char *>(out.data.data()), count * sizeof(float));
    if (!file)
        fail(path + ": truncated data");

    return out;
}

void saveNpy(const std::string &path, const std::vector<int64_t> &dims, const float *data)
{
    std::ostringstream shape;
    shape << "(";
    for (size_t i = 0; i < dims.size(); ++i)
        shape << dims[i] << (dims.size() == 1 ? "," : (i + 1 < dims.size() ? ", " : ""));
    shape << ")";

    std::string header = "{'descr': '<f4', 'fortran_order': False, 'shape': " + shape.str() + ", }";
    size_t total = 10 + header.size() + 1;
    size_t padded = (total + 63) / 64 * 64;
    header += std::string(padded - total, ' ');
    header += '\n';

    std::ofstream file(path, std::ios::binary);
    if (!file)
        fail("cannot write " + path);
    file.write("\x93NUMPY\x01\x00", 8);

    uint16_t len = static_cast<uint16_t>(header.size());
    file.write(reinterpret_cast<char *>(&len), 2);
    file.write(header.data(), header.size());

    int64_t count = 1;
    for (int64_t d : dims)
        count *= d;
    file.write(reinterpret_cast<const char *>(data), count * sizeof(float));
    if (!file)
        fail("cannot write " + path);
}

// -- the custom operators on CPU tensors: the wrappers' plain versions ----------------------------

void checkMatmul(const at::Tensor &a, const at::Tensor &b)
{
    TORCH_CHECK(a.device() == b.device(), "matmul operands on ", a.device(), " and ", b.device());
    TORCH_CHECK(a.dim() == 2 && b.dim() == 2 && a.size(1) == b.size(0), "matmul takes (M, K) @ (K, N), got ",
                a.sizes(), " @ ", b.sizes());
    const auto t = a.scalar_type();
    TORCH_CHECK(t == b.scalar_type() && (t == at::kFloat || t == at::kBFloat16 || t == at::kHalf || t == at::kChar),
                "matmul takes two f32, bf16, f16 or int8 matrices of one type, got ", a.scalar_type(), " and ",
                b.scalar_type());
}

void checkMatmulNT(const at::Tensor &a, const at::Tensor &bt)
{
    TORCH_CHECK(a.device() == bt.device(), "matmulNT operands on ", a.device(), " and ", bt.device());
    TORCH_CHECK(a.dim() == 2 && bt.dim() == 2 && a.size(1) == bt.size(1), "matmulNT takes (M, K) @ (N, K)^T, got ",
                a.sizes(), " @ ", bt.sizes(), "^T");
    TORCH_CHECK(a.scalar_type() == at::kChar && bt.scalar_type() == at::kChar,
                "matmulNT takes two int8 matrices, got ", a.scalar_type(), " and ", bt.scalar_type());
}

// matmul.plain: f32 products in a's type; int8 exactly, in f64, to int32
at::Tensor matmulPlain(const at::Tensor &a, const at::Tensor &b)
{
    if (a.scalar_type() == at::kChar)
        return at::matmul(a.to(at::kDouble), b.to(at::kDouble)).to(at::kInt);
    return at::matmul(a.to(at::kFloat), b.to(at::kFloat)).to(a.scalar_type());
}

at::Tensor matmulCpu(const at::Tensor &a, const at::Tensor &b)
{
    ++calls["matmul"];
    checkMatmul(a, b);
    return matmulPlain(a, b);
}

at::Tensor matmulNTCpu(const at::Tensor &a, const at::Tensor &bt)
{
    ++calls["matmul_nt"];
    checkMatmulNT(a, bt);
    return matmulPlain(a, bt.t());
}

// F(2x2, 3x3): Y = A^T [(G g G^T) . (B^T d B)] A, the constants of winograd.py
const float BT[4][4] = {{1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
const float AT[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
const float G[4][3] = {{1, 0, 0}, {.5f, .5f, .5f}, {.5f, -.5f, .5f}, {0, 0, 1}};

// kron(G, G) (16, 9) in f32, per device, built once (winograd._kronG)
at::Tensor kronG(const at::Device &device)
{
    static std::map<std::string, at::Tensor> made;
    auto &gg = made[device.str()];
    if (!gg.defined()) {
        auto host = at::empty({16, 9}, at::kFloat);
        auto *p = host.data_ptr<float>();
        for (int i = 0; i < 4; ++i)
            for (int k = 0; k < 4; ++k)
                for (int j = 0; j < 3; ++j)
                    for (int l = 0; l < 3; ++l)
                        p[(i * 4 + k) * 9 + j * 3 + l] = G[i][j] * G[k][l];
        gg = host.to(device);
    }
    return gg;
}

at::Tensor constant(const float *values, int64_t rows, int64_t cols, const at::Device &device)
{
    return at::from_blob(const_cast<float *>(values), {rows, cols}, at::kFloat).clone().to(device);
}

// winograd.filterTransform: (CO, C, 3, 3) -> U (16, C, CO) in w's type
at::Tensor filterTransform(const at::Tensor &w)
{
    const int64_t co = w.size(0), c = w.size(1);
    auto taps = w.to(at::kFloat).permute({2, 3, 1, 0}).reshape({9, c * co});
    return at::matmul(kronG(w.device()), taps).reshape({16, c, co}).to(w.scalar_type());
}

std::vector<int64_t> winogradPad(c10::SymIntArrayRef pad)
{
    std::vector<int64_t> out;
    for (const auto &p : pad)
        out.push_back(p.expect_int());
    return out;
}

void checkWinograd(const at::Tensor &x, const at::Tensor &w, const std::vector<int64_t> &pad)
{
    TORCH_CHECK(x.device() == w.device(), "winograd conv operands on ", x.device(), " and ", w.device());
    TORCH_CHECK(x.dim() == 4 && w.dim() == 4 && w.size(1) == x.size(1) && w.size(2) == 3 && w.size(3) == 3,
                "winograd conv takes NCHW x and (CO, C, 3, 3) w, got ", x.sizes(), " and ", w.sizes());
    TORCH_CHECK(pad.size() == 2 && pad[0] >= 0 && pad[1] >= 0, "winograd conv takes two non-negative paddings");
    TORCH_CHECK(x.size(2) + 2 * pad[0] - 2 >= 1 && x.size(3) + 2 * pad[1] - 2 >= 1, "winograd conv of ", x.sizes(),
                " with pad (", pad[0], ", ", pad[1], ") has no output");
}

// winograd.plain, with _inputTransform: each butterfly stage rounded to x's type
at::Tensor winogradPlain(const at::Tensor &x, const at::Tensor &w, const std::vector<int64_t> &pad)
{
    const int64_t n = x.size(0), c = x.size(1), h = x.size(2), wd = x.size(3), co = w.size(0);
    const int64_t oh = h + 2 * pad[0] - 2, ow = wd + 2 * pad[1] - 2;
    const int64_t th = (oh + 1) / 2, tw = (ow + 1) / 2;
    const auto type = x.scalar_type();

    auto at = constant(&AT[0][0], 2, 4, x.device());

    auto xp = at::pad(x.to(at::kFloat), {pad[1], 2 * tw + 2 - wd - pad[1], pad[0], 2 * th + 2 - h - pad[0]},
                      "constant", std::nullopt);
    auto d = xp.unfold(2, 4, 2).unfold(3, 4, 2);
    auto bt = constant(&BT[0][0], 4, 4, x.device());
    auto t = at::einsum("xa,nchwab->nchwxb", {bt, d}).to(type).to(at::kFloat);
    auto v = at::einsum("nchwxb,yb->nchwxy", {t, bt}).to(type).to(at::kFloat);

    auto u = filterTransform(w).to(at::kFloat).reshape({4, 4, c, co});
    auto m = at::einsum("nchwxy,xyco->nohwxy", {v, u});
    // torch.einsum hands three operands to opt_einsum, whose path here is (0, 1), (0, 1)
    const std::vector<int64_t> path = {0, 1, 0, 1};
    auto y = at::einsum("ax,nohwxy,by->nohawb", {at, m, at}, path);

    using at::indexing::Slice;
    return y.reshape({n, co, 2 * th, 2 * tw}).index({Slice(), Slice(), Slice(0, oh), Slice(0, ow)}).to(type);
}

at::Tensor winogradCpu(const at::Tensor &x, const at::Tensor &w, c10::SymIntArrayRef padSym)
{
    ++calls["winograd_conv2d"];
    const auto pad = winogradPad(padSym);
    checkWinograd(x, w, pad);
    return winogradPlain(x, w, pad);
}

void checkFlash(const at::Tensor &q, const at::Tensor &k, const at::Tensor &v)
{
    TORCH_CHECK(q.device() == k.device() && k.device() == v.device(), "flash operands on ", q.device(), ", ",
                k.device(), " and ", v.device());
    TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && k.sizes() == v.sizes() && q.size(0) == k.size(0) &&
                    q.size(1) == k.size(1) && q.size(3) == k.size(3),
                "flash takes q (batch, heads, seqQ, d), k and v (batch, heads, seqK, d), got ", q.sizes(), ", ",
                k.sizes(), ", ", v.sizes());
    TORCH_CHECK(q.scalar_type() == k.scalar_type() && k.scalar_type() == v.scalar_type(),
                "flash takes operands of one type");
    TORCH_CHECK(k.size(2) != 0, "flash needs at least one key");
}

// flash.plain: f32 scores, the bottom-right causal mask at -1e30, P rounded to q's type
std::tuple<at::Tensor, at::Tensor> flashPlain(const at::Tensor &q, const at::Tensor &k, const at::Tensor &v,
                                              bool causal)
{
    const int64_t batch = q.size(0), heads = q.size(1), seqQ = q.size(2), d = q.size(3), seqK = k.size(2);

    auto s = at::matmul(q.to(at::kFloat) * (1.0 / std::sqrt(static_cast<double>(d))),
                        k.to(at::kFloat).transpose(-1, -2));
    if (causal) {
        auto qPos = at::arange(seqQ, at::TensorOptions().dtype(at::kLong).device(s.device())).unsqueeze(1);
        auto kPos = at::arange(seqK, at::TensorOptions().dtype(at::kLong).device(s.device())).unsqueeze(0);
        s = s.masked_fill(qPos + (seqK - seqQ) < kPos, -1e30);
    }

    auto m = s.amax({-1}, true);
    auto p = at::exp(s - m);
    auto l = p.sum({-1}, true);

    auto out = at::matmul(p.to(q.scalar_type()).to(at::kFloat), v.to(at::kFloat)) / l;
    auto lse = (m + at::log(l)).reshape({batch * heads, 1, seqQ});
    return {out.to(q.scalar_type()), lse};
}

std::tuple<at::Tensor, at::Tensor> flashCpu(const at::Tensor &q, const at::Tensor &k, const at::Tensor &v,
                                            bool causal)
{
    ++calls["flash"];
    checkFlash(q, k, v);
    return flashPlain(q, k, v, causal);
}

}  // namespace

TORCH_LIBRARY(puzzlelib, m)
{
    m.def("matmul(Tensor a, Tensor b) -> Tensor");
    m.def("matmul_nt(Tensor a, Tensor bt) -> Tensor");
    m.def("winograd_conv2d(Tensor x, Tensor w, SymInt[] pad) -> Tensor");
    m.def("flash(Tensor q, Tensor k, Tensor v, bool causal) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(puzzlelib, CPU, m)
{
    m.impl("matmul", matmulCpu);
    m.impl("matmul_nt", matmulNTCpu);
    m.impl("winograd_conv2d", winogradCpu);
    m.impl("flash", flashCpu);
}

// -- the custom operators on CUDA tensors: the wrappers' launches --------------------------------

#ifdef PL_WITH_CUDA

extern "C" int pl_matmul_splits(int m, int n, int k, int dtype, int path, int sms);
extern "C" int pl_matmul(const void *a, const void *b, void *c, void *partial, int m, int n, int k, int dtype,
                         int path, int slices, void *stream);
extern "C" int pl_winograd_f23(const void *x, const void *u, void *y, int n, int h, int w, int c, int co, int padH,
                               int padW, void *stream);
extern "C" int pl_flash_forward(const void *q, const void *k, const void *v, void *o, float *lse, int bh, int seqQ,
                                int seqK, int d, int dtype, int causal, int rows, void *stream);

namespace {

int smCount(const at::Device &device) { return at::cuda::getDeviceProperties(device.index())->multiProcessorCount; }

void *streamOf(const at::Device &device) { return at::cuda::getCurrentCUDAStream(device.index()).stream(); }

int matmulType(at::ScalarType t)
{
    switch (t) {
    case at::kFloat: return routes::F32;
    case at::kBFloat16: return routes::BF16;
    case at::kHalf: return routes::F16;
    default: return routes::INT8;
    }
}

bool isWgmma(int path) { return path == routes::WGMMA_64 || path == routes::WGMMA_128; }

void onCard(const at::Tensor &a, const at::Tensor &b, const char *name)
{
    TORCH_CHECK(a.device().is_cuda(), name, " runs on CUDA or CPU tensors, got ", a.device());
    TORCH_CHECK(a.is_contiguous() && b.is_contiguous(), name, " takes contiguous row-major operands");
}

int pathOf(const at::Tensor &a, const at::Tensor &b, int64_t n)
{
    const bool aligned = reinterpret_cast<uintptr_t>(a.data_ptr()) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(b.data_ptr()) % 16 == 0;
    return routes::matmulRoute(a.size(0), n, a.size(1), matmulType(a.scalar_type()), aligned, smCount(a.device()));
}

// matmul._launch: one launch of K1 on path into out (M, N); b is (K, N), or
// for int8 on wgmma the (N, K) table B^T
void matmulLaunch(const at::Tensor &a, const at::Tensor &b, const at::Tensor &out, int path, const char *op)
{
    const int m = a.size(0), k = a.size(1), n = out.size(1);
    const int dtype = matmulType(a.scalar_type());

    const int slices = pl_matmul_splits(m, n, k, dtype, path, smCount(a.device()));
    at::Tensor partial;
    if (slices > 1)
        partial = at::empty({slices, m, n}, a.options().dtype(dtype == routes::INT8 ? at::kInt : at::kFloat));

    c10::cuda::CUDAGuard guard(a.device());
    const int err = pl_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), slices > 1 ? partial.data_ptr() : nullptr,
                              m, n, k, dtype, path, slices, streamOf(a.device()));
    TORCH_CHECK(err == 0, "matmul kernel launch failed for ", a.sizes(), " @ ", b.sizes(), " ", a.scalar_type(),
                " on path ", path, ": cudaError ", err);
    ++launches[op];
}

// matmul._launchRows: the tiled paths' row blocks lie on the grid's second axis
void matmulLaunchRows(const at::Tensor &a, const at::Tensor &b, const at::Tensor &out, int path, const char *op)
{
    const int64_t chunk = routes::BLOCK_ROWS * routes::MAX_GRID_Y;
    for (int64_t row = 0; row < a.size(0); row += chunk)
        matmulLaunch(a.slice(0, row, row + chunk), b, out.slice(0, row, row + chunk), path, op);
}

at::Tensor matmulCuda(const at::Tensor &a, const at::Tensor &b)
{
    ++calls["matmul"];
    checkMatmul(a, b);
    onCard(a, b, "matmul");

    const int64_t n = b.size(1);
    const bool int8 = a.scalar_type() == at::kChar;
    auto out = at::empty({a.size(0), n}, a.options().dtype(int8 ? at::kInt : a.scalar_type()));

    const int path = pathOf(a, b, n);
    if (int8 && isWgmma(path))
        matmulLaunch(a, b.t().contiguous(), out, path, "matmul");
    else
        matmulLaunchRows(a, b, out, path, "matmul");
    return out;
}

at::Tensor matmulNTCuda(const at::Tensor &a, const at::Tensor &bt)
{
    ++calls["matmul_nt"];
    checkMatmulNT(a, bt);
    onCard(a, bt, "matmulNT");

    const int64_t n = bt.size(0);
    auto out = at::empty({a.size(0), n}, a.options().dtype(at::kInt));

    const int path = pathOf(a, bt, n);
    if (isWgmma(path))
        matmulLaunch(a, bt, out, path, "matmul_nt");
    else
        matmulLaunchRows(a, bt.t().contiguous(), out, path, "matmul_nt");
    return out;
}

// K2's blocking (csrc/winograd.cu): input channels per step, output channels per block
constexpr int K2_BK = 32, K2_BN = 128;

// winograd.conv2dNHWC: contiguous NHWC bf16 xh and U (16, C, CO) -> NHWC y
at::Tensor winogradNHWC(const at::Tensor &xh, const at::Tensor &u, const std::vector<int64_t> &pad)
{
    TORCH_CHECK(xh.scalar_type() == at::kBFloat16 && u.scalar_type() == at::kBFloat16,
                "the winograd kernel takes bf16 x and U, got ", xh.scalar_type(), " and ", u.scalar_type());

    const int n = xh.size(0), h = xh.size(1), wd = xh.size(2), c = xh.size(3), co = u.size(2);
    const int oh = h + 2 * pad[0] - 2, ow = wd + 2 * pad[1] - 2;

    TORCH_CHECK(xh.is_contiguous() && u.is_contiguous() && u.size(0) == 16 && u.size(1) == c,
                "the winograd kernel takes contiguous NHWC x and (16, C, CO) U, got ", xh.sizes(), " and ", u.sizes());
    TORCH_CHECK(c > 0 && c % K2_BK == 0 && co > 0 && co % K2_BN == 0, "the winograd kernel takes C and CO positive "
                "multiples of ", K2_BK, " and ", K2_BN, ", got ", c, " and ", co);
    TORCH_CHECK(xh.device().is_cuda() && u.device() == xh.device(), "the winograd kernel runs on CUDA tensors");
    TORCH_CHECK(reinterpret_cast<uintptr_t>(xh.data_ptr()) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(u.data_ptr()) % 16 == 0,
                "the winograd kernel needs x and U 16-byte aligned");

    auto y = at::empty({n, oh, ow, co}, xh.options());

    c10::cuda::CUDAGuard guard(xh.device());
    const int err = pl_winograd_f23(xh.data_ptr(), u.data_ptr(), y.data_ptr(), n, h, wd, c, co, pad[0], pad[1],
                                    streamOf(xh.device()));
    TORCH_CHECK(err == 0, "winograd kernel launch failed for x ", xh.sizes(), ", U ", u.sizes(), ": cudaError ", err);
    ++launches["winograd_conv2d"];
    return y;
}

at::Tensor winogradCuda(const at::Tensor &x, const at::Tensor &w, c10::SymIntArrayRef padSym)
{
    ++calls["winograd_conv2d"];
    const auto pad = winogradPad(padSym);
    checkWinograd(x, w, pad);

    auto xh = x.permute({0, 2, 3, 1}).contiguous();
    return winogradNHWC(xh, filterTransform(w), pad).permute({0, 3, 1, 2});
}

std::tuple<at::Tensor, at::Tensor> flashCuda(const at::Tensor &qIn, const at::Tensor &kIn, const at::Tensor &vIn,
                                             bool causal)
{
    ++calls["flash"];
    checkFlash(qIn, kIn, vIn);
    TORCH_CHECK(qIn.device().is_cuda(), "flash runs on CUDA or CPU tensors, got ", qIn.device());

    const int64_t batch = qIn.size(0), heads = qIn.size(1), seqQ = qIn.size(2), d = qIn.size(3);
    const int64_t seqK = kIn.size(2);
    const int rows = routes::flashBlockRows(seqQ, batch * heads, d, smCount(qIn.device()));

    // flash._cudaOperands
    const auto type = qIn.scalar_type();
    TORCH_CHECK(type == at::kBFloat16 || type == at::kHalf, "the flash kernels take bf16 or f16 (Hopper's tensor "
                "cores have no f32 mode), got ", type);
    TORCH_CHECK(d == 32 || d == 64 || d == 128, "the flash kernels take head dims (32, 64, 128), got ", d);
    auto q = qIn.contiguous(), k = kIn.contiguous(), v = vIn.contiguous();
    for (const auto *t : {&q, &k, &v})
        TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                    "the flash kernels take 16-byte aligned operands");

    auto out = at::empty_like(q);
    auto lse = at::empty({batch * heads, 1, seqQ}, q.options().dtype(at::kFloat));
    if (batch * heads == 0 || seqQ == 0)
        return {out, lse};

    c10::cuda::CUDAGuard guard(q.device());
    const int err = pl_flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     lse.data_ptr<float>(), batch * heads, seqQ, seqK, d,
                                     type == at::kBFloat16 ? 1 : 2, causal ? 1 : 0, rows, streamOf(q.device()));
    TORCH_CHECK(err == 0, "flash kernel launch (wgmma-", rows, ") failed for q ", q.sizes(), ", k ", k.sizes(), " ",
                type, ": cudaError ", err);
    ++launches["flash"];
    return {out, lse};
}

}  // namespace

TORCH_LIBRARY_IMPL(puzzlelib, CUDA, m)
{
    m.impl("matmul", matmulCuda);
    m.impl("matmul_nt", matmulNTCuda);
    m.impl("winograd_conv2d", winogradCuda);
    m.impl("flash", flashCuda);
}

#endif  // PL_WITH_CUDA

// -- the program ---------------------------------------------------------------------------------

namespace {

std::vector<std::string> split(const std::string &text, char sep)
{
    std::vector<std::string> parts;
    std::string part;
    std::istringstream in(text);
    while (std::getline(in, part, sep))
        parts.push_back(part);
    if (!text.empty() && text.back() == sep)
        parts.push_back("");
    return parts;
}

int64_t toInt(const std::string &text, const std::string &where)
{
    char *end = nullptr;
    errno = 0;
    const long long value = std::strtoll(text.c_str(), &end, 10);
    if (text.empty() || *end != '\0' || errno != 0)
        fail(where + ": not an integer: '" + text + "'");
    return value;
}

double toFloat(const std::string &text, const std::string &where)
{
    char *end = nullptr;
    const double value = std::strtod(text.c_str(), &end);
    if (text.empty() || *end != '\0')
        fail(where + ": not a float: '" + text + "'");
    return value;
}

at::ScalarType scalarType(const std::string &name, const std::string &where)
{
    static const std::unordered_map<std::string, at::ScalarType> types = {
        {"Float", at::kFloat}, {"Double", at::kDouble}, {"Half", at::kHalf}, {"BFloat16", at::kBFloat16},
        {"Char", at::kChar},   {"Byte", at::kByte},     {"Short", at::kShort}, {"Int", at::kInt},
        {"Long", at::kLong},   {"Bool", at::kBool}};
    auto it = types.find(name);
    if (it == types.end())
        fail(where + ": unknown dtype '" + name + "'");
    return it->second;
}

std::string unquote(const std::string &text, const std::string &where)
{
    std::string out;
    for (size_t i = 0; i < text.size(); ++i) {
        if (text[i] != '%') {
            out += text[i];
            continue;
        }
        if (i + 2 >= text.size())
            fail(where + ": malformed string '" + text + "'");
        out += static_cast<char>(std::stoi(text.substr(i + 1, 2), nullptr, 16));
        i += 2;
    }
    return out;
}

struct Constant {
    std::string name;
    at::ScalarType dtype;
    std::vector<int64_t> sizes, strides;
    int64_t offset, first, bytes;
};

struct Node {
    std::string name, op, overload;
    std::vector<std::string> positional;
    std::vector<std::pair<std::string, std::string>> keywords;
    std::optional<c10::OperatorHandle> handle;
    // getitem: the source node and the index
    std::string source;
    int64_t index = -1;
    int line = 0;
};

struct Input {
    std::string name;
    std::vector<int64_t> sizes;
};

struct Program {
    std::string device, weightsFile, output;
    int64_t weightsBytes = -1;
    std::vector<Input> inputs;
    std::vector<Constant> constants;
    std::vector<Node> nodes;
};

std::string dirOf(const std::string &path)
{
    const auto slash = path.rfind('/');
    return slash == std::string::npos ? "." : path.substr(0, slash);
}

Program parseProgram(const std::string &path)
{
    std::ifstream file(path);
    if (!file)
        fail("cannot open " + path);

    Program program;
    std::string line;
    int number = 0;
    bool header = false;

    while (std::getline(file, line)) {
        ++number;
        const std::string where = path + ":" + std::to_string(number);
        std::istringstream in(line);
        std::vector<std::string> tok;
        for (std::string t; in >> t;)
            tok.push_back(t);
        if (tok.empty())
            continue;

        auto need = [&](size_t count) {
            if (tok.size() < count)
                fail(where + ": malformed '" + tok[0] + "' line");
        };

        if (!header) {
            if (line != "puzzlelib-engine-program 1")
                fail(where + ": not an engine program (expected 'puzzlelib-engine-program 1')");
            header = true;
        } else if (tok[0] == "device") {
            need(2);
            program.device = tok[1];
        } else if (tok[0] == "weights") {
            need(3);
            program.weightsFile = tok[1];
            program.weightsBytes = toInt(tok[2], where);
        } else if (tok[0] == "input") {
            need(4);
            Input input{tok[1], {}};
            if (scalarType(tok[2], where) != at::kFloat)
                fail(where + ": the driver takes f32 inputs, this one is " + tok[2]);
            const auto ndim = toInt(tok[3], where);
            need(4 + ndim);
            for (int64_t i = 0; i < ndim; ++i)
                input.sizes.push_back(toInt(tok[4 + i], where));
            if (tok.size() != size_t(4 + ndim))
                fail(where + ": malformed 'input' line");
            program.inputs.push_back(input);
        } else if (tok[0] == "const") {
            need(4);
            Constant c;
            c.name = tok[1];
            c.dtype = scalarType(tok[2], where);
            const auto ndim = toInt(tok[3], where);
            if (tok.size() != size_t(4 + 2 * ndim + 3))
                fail(where + ": malformed 'const' line");
            for (int64_t i = 0; i < ndim; ++i) {
                c.sizes.push_back(toInt(tok[4 + i], where));
                c.strides.push_back(toInt(tok[4 + ndim + i], where));
            }
            c.offset = toInt(tok[4 + 2 * ndim], where);
            c.first = toInt(tok[5 + 2 * ndim], where);
            c.bytes = toInt(tok[6 + 2 * ndim], where);
            program.constants.push_back(c);
        } else if (tok[0] == "node") {
            need(6);
            Node node;
            node.name = tok[1];
            node.op = tok[2];
            node.overload = tok[3] == "default" ? "" : tok[3];
            node.line = number;
            const auto npos = toInt(tok[4], where), nkw = toInt(tok[5], where);
            if (npos < 0 || nkw < 0 || tok.size() != size_t(6 + npos + nkw))
                fail(where + ": malformed 'node' line");
            for (int64_t i = 0; i < npos; ++i)
                node.positional.push_back(tok[6 + i]);
            for (int64_t i = 0; i < nkw; ++i) {
                const auto &kw = tok[6 + npos + i];
                const auto eq = kw.find('=');
                if (eq == std::string::npos || eq == 0)
                    fail(where + ": malformed keyword '" + kw + "'");
                node.keywords.emplace_back(kw.substr(0, eq), kw.substr(eq + 1));
            }
            program.nodes.push_back(node);
        } else if (tok[0] == "getitem") {
            need(4);
            if (tok.size() != 4)
                fail(where + ": malformed 'getitem' line");
            Node node;
            node.name = tok[1];
            node.source = tok[2];
            node.index = toInt(tok[3], where);
            node.line = number;
            program.nodes.push_back(node);
        } else if (tok[0] == "output") {
            if (tok.size() != 2)
                fail(where + ": malformed 'output' line");
            program.output = tok[1];
        } else {
            fail(where + ": unknown record '" + tok[0] + "'");
        }
    }

    if (!header)
        fail(path + ": empty program");
    if (program.device.empty() || program.weightsFile.empty() || program.output.empty())
        fail(path + ": the program lacks its device, weights or output line");
    return program;
}

// -- the interpreter -----------------------------------------------------------------------------

using Env = std::unordered_map<std::string, std::vector<c10::IValue>>;

const c10::IValue &lookup(const Env &env, const std::string &name, const std::string &where)
{
    auto it = env.find(name);
    if (it == env.end())
        fail(where + ": no value named '" + name + "' before this node");
    if (it->second.size() != 1)
        fail(where + ": '" + name + "' has " + std::to_string(it->second.size()) + " results, not one");
    return it->second[0];
}

at::Tensor tensorOf(const Env &env, const std::string &name, const std::string &where)
{
    const auto &value = lookup(env, name, where);
    if (!value.isTensor())
        fail(where + ": '" + name + "' is no tensor");
    return value.toTensor();
}

c10::TypePtr unwrapOptional(const c10::TypePtr &type)
{
    if (type->kind() == c10::TypeKind::OptionalType)
        return type->castRaw<c10::OptionalType>()->getElementType();
    return type;
}

c10::IValue toIValue(const std::string &token, const c10::TypePtr &declared, const Env &env,
                     const std::string &where)
{
    const auto type = unwrapOptional(declared);
    const auto colon = token.find(':');
    const std::string kind = token.substr(0, colon), text = colon == std::string::npos ? "" : token.substr(colon + 1);

    if (token == "N")
        return c10::IValue();
    if (colon == std::string::npos)
        fail(where + ": malformed argument '" + token + "'");

    if (kind == "T")
        return tensorOf(env, text, where);
    if (type->kind() == c10::TypeKind::TensorType && (kind == "i" || kind == "f" || kind == "b")) {
        // a number where the schema takes a tensor, as Python's binding
        // takes it: a 0-dim CPU tensor marked as a wrapped number
        at::Tensor number = kind == "f"   ? at::scalar_tensor(toFloat(text, where), at::kDouble)
                            : kind == "i" ? at::scalar_tensor(toInt(text, where), at::kLong)
                                          : at::scalar_tensor(text == "1", at::kBool);
        number.unsafeGetTensorImpl()->set_wrapped_number(true);
        return number;
    }
    if (kind == "i") {
        const auto value = toInt(text, where);
        if (type->kind() == c10::TypeKind::FloatType)
            return static_cast<double>(value);
        return value;
    }
    if (kind == "f")
        return toFloat(text, where);
    if (kind == "b")
        return text == "1";
    if (kind == "s")
        return scalarType(text, where);
    if (kind == "l") {
        if (text != "Strided")
            fail(where + ": unsupported layout '" + text + "'");
        return c10::Layout::Strided;
    }
    if (kind == "m") {
        static const std::unordered_map<std::string, c10::MemoryFormat> formats = {
            {"Contiguous", c10::MemoryFormat::Contiguous}, {"ChannelsLast", c10::MemoryFormat::ChannelsLast},
            {"Preserve", c10::MemoryFormat::Preserve}, {"ChannelsLast3d", c10::MemoryFormat::ChannelsLast3d}};
        auto it = formats.find(text);
        if (it == formats.end())
            fail(where + ": unknown memory format '" + text + "'");
        return it->second;
    }
    if (kind == "d")
        return c10::Device(text);
    if (kind == "S")
        return unquote(text, where);

    const bool list = type->kind() == c10::TypeKind::ListType;
    const auto element = list ? type->castRaw<c10::ListType>()->getElementType() : nullptr;
    const bool optionalTensors = list && element->kind() == c10::TypeKind::OptionalType;

    if (kind == "I") {
        c10::List<int64_t> values;
        for (const auto &part : split(text, ','))
            values.push_back(toInt(part, where));
        return values;
    }
    if (kind == "F") {
        c10::List<double> values;
        for (const auto &part : split(text, ','))
            values.push_back(toFloat(part, where));
        return values;
    }
    if (kind == "B") {
        c10::List<bool> values;
        for (const auto &part : split(text, ','))
            values.push_back(part == "1");
        return values;
    }
    if (kind == "TL") {
        if (optionalTensors) {
            c10::List<std::optional<at::Tensor>> values;
            for (const auto &part : split(text, ','))
                values.push_back(part == "~" ? std::optional<at::Tensor>() : tensorOf(env, part, where));
            return values;
        }
        c10::List<at::Tensor> values;
        for (const auto &part : split(text, ',')) {
            if (part == "~")
                fail(where + ": None in a list of tensors that takes none");
            values.push_back(tensorOf(env, part, where));
        }
        return values;
    }
    if (kind == "E") {
        if (!list)
            fail(where + ": an empty list where the schema takes " + type->str());
        switch (element->kind()) {
        case c10::TypeKind::IntType:
        case c10::TypeKind::SymIntType: return c10::List<int64_t>();
        case c10::TypeKind::FloatType: return c10::List<double>();
        case c10::TypeKind::BoolType: return c10::List<bool>();
        case c10::TypeKind::TensorType: return c10::List<at::Tensor>();
        case c10::TypeKind::OptionalType: return c10::List<std::optional<at::Tensor>>();
        default: fail(where + ": an empty list of " + element->str());
        }
    }

    fail(where + ": unknown argument kind '" + kind + "'");
}

void resolve(Program &program)
{
    auto &dispatcher = c10::Dispatcher::singleton();
    for (auto &node : program.nodes) {
        if (node.index >= 0)
            continue;
        node.handle = dispatcher.findSchema({node.op, node.overload});
        if (!node.handle)
            fail("line " + std::to_string(node.line) + ", node " + node.name + ": no operator " + node.op +
                 (node.overload.empty() ? "" : "." + node.overload) + " is registered in this driver");
    }
}

void runNode(const Node &node, Env &env)
{
    const std::string where = "node " + node.name + " (line " + std::to_string(node.line) + ")";

    if (node.index >= 0) {
        auto it = env.find(node.source);
        if (it == env.end())
            fail(where + ": no value named '" + node.source + "'");
        const auto &values = it->second;
        c10::IValue picked;
        if (values.size() > 1) {
            if (node.index >= int64_t(values.size()))
                fail(where + ": index " + std::to_string(node.index) + " out of range");
            picked = values[node.index];
        } else if (values.size() == 1 && values[0].isList()) {
            auto items = values[0].toList();
            if (node.index >= int64_t(items.size()))
                fail(where + ": index " + std::to_string(node.index) + " out of range");
            picked = items.get(node.index);
        } else if (values.size() == 1 && values[0].isTuple()) {
            const auto &items = values[0].toTupleRef().elements();
            if (node.index >= int64_t(items.size()))
                fail(where + ": index " + std::to_string(node.index) + " out of range");
            picked = items[node.index];
        } else {
            fail(where + ": '" + node.source + "' has nothing to index");
        }
        env[node.name] = {picked};
        return;
    }

    const auto &schema = node.handle->schema();
    const auto &arguments = schema.arguments();
    if (node.positional.size() > arguments.size())
        fail(where + ": " + std::to_string(node.positional.size()) + " positional arguments for " + schema.name());

    torch::jit::Stack stack;
    size_t used = 0;
    for (size_t i = 0; i < arguments.size(); ++i) {
        const auto &arg = arguments[i];
        if (i < node.positional.size()) {
            stack.push_back(toIValue(node.positional[i], arg.type(), env, where));
            continue;
        }

        const std::string *given = nullptr;
        for (const auto &[name, token] : node.keywords)
            if (name == arg.name())
                given = &token;

        if (given != nullptr) {
            stack.push_back(toIValue(*given, arg.type(), env, where));
            ++used;
        } else if (arg.default_value()) {
            stack.push_back(*arg.default_value());
        } else {
            fail(where + ": argument '" + arg.name() + "' of " + schema.name() + " is not given and has no default");
        }
    }
    if (used != node.keywords.size())
        fail(where + ": a keyword that " + schema.name() + " does not take");

    node.handle->callBoxed(&stack);
    env[node.name] = std::vector<c10::IValue>(stack.begin(), stack.end());
}

// the program's constants, each in a storage of its own with its strides and storage offset
Env loadConstants(const Program &program, const std::string &programPath, const at::Device &device)
{
    const std::string weightsPath = dirOf(programPath) + "/" + program.weightsFile;
    std::ifstream file(weightsPath, std::ios::binary | std::ios::ate);
    if (!file)
        fail("cannot open " + weightsPath);
    const int64_t size = file.tellg();
    if (size != program.weightsBytes)
        fail(weightsPath + " holds " + std::to_string(size) + " bytes, the program names " +
             std::to_string(program.weightsBytes) + " (truncated or another engine's)");

    std::vector<char> blob(size);
    file.seekg(0);
    file.read(blob.data(), size);
    if (!file)
        fail(weightsPath + ": short read");

    Env env;
    for (const auto &c : program.constants) {
        const int64_t item = c10::elementSize(c.dtype);
        if (c.first < 0 || c.bytes < 0 || c.bytes % item != 0 || c.first + c.bytes > size)
            fail("constant " + c.name + ": bytes [" + std::to_string(c.first) + ", +" + std::to_string(c.bytes) +
                 ") outside the " + std::to_string(size) + " bytes of " + weightsPath);

        auto host = at::empty({c.bytes / item}, at::TensorOptions().dtype(c.dtype));
        std::memcpy(host.data_ptr(), blob.data() + c.first, c.bytes);
        env[c.name] = {host.to(device).as_strided(c.sizes, c.strides, c.offset)};
    }
    return env;
}

// what backend/device.py ensureInit sets at Config.matmulPrecision = "highest"
void pinPrecision()
{
    auto &ctx = at::globalContext();
    ctx.setAllowTF32CuBLAS(false);
    ctx.setAllowTF32CuDNN(false);
    ctx.setAllowBF16ReductionCuBLAS(false);
    ctx.setAllowFP16ReductionCuBLAS(false);
}

void synchronize(const at::Device &device)
{
#ifdef PL_WITH_CUDA
    if (device.is_cuda())
        c10::cuda::getCurrentCUDAStream(device.index()).synchronize();
#else
    (void)device;
#endif
}

double msSince(std::chrono::steady_clock::time_point start)
{
    return std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - start).count();
}

std::string counts(std::map<std::string, long long> &counter)
{
    std::string out = "{";
    for (const char *op : OPERATORS)
        out += std::string(out.size() > 1 ? ", " : "") + "\"" + op + "\": " + std::to_string(counter[op]);
    return out + "}";
}

int run(int argc, char **argv)
{
    int runs = 1, first = 1;
    if (argc > 2 && std::string(argv[1]) == "--runs") {
        runs = static_cast<int>(toInt(argv[2], "--runs"));
        if (runs < 1)
            fail("--runs takes a positive count");
        first = 3;
    }

    if (argc - first < 3) {
        std::fprintf(stderr, "usage: %s [--runs N] <device: cuda|cpu> <program> <output.npy> [input1.npy ...]\n",
                     argv[0]);
        return 2;
    }

    const std::string wanted = argv[first], programPath = argv[first + 1], outputPath = argv[first + 2];
    if (wanted != "cuda" && wanted != "cpu")
        fail("the device is cuda or cpu, got '" + wanted + "'");

    const auto loadStart = std::chrono::steady_clock::now();
    Program program = parseProgram(programPath);

    const at::Device device(program.device);
    if (device.type() != (wanted == "cuda" ? at::kCUDA : at::kCPU))
        fail(programPath + " was built for " + program.device + ", not for " + wanted);
#ifndef PL_WITH_CUDA
    if (device.is_cuda())
        fail(programPath + " was built for " + program.device + ": this driver was built without CUDA "
             "(against a CPU-only torch) and runs cpu programs only");
#endif

    const int inputs = argc - first - 3;
    if (inputs != int(program.inputs.size()))
        fail(programPath + " takes " + std::to_string(program.inputs.size()) + " input(s), got " +
             std::to_string(inputs));

    pinPrecision();
    c10::InferenceMode inference;
    resolve(program);
    Env constants = loadConstants(program, programPath, device);
    synchronize(device);
    const double loadMs = msSince(loadStart);

    std::vector<at::Tensor> given;
    for (int i = 0; i < inputs; ++i) {
        const auto &want = program.inputs[i];
        const auto array = loadNpy(argv[first + 3 + i]);
        if (array.dims != want.sizes)
            fail(std::string(argv[first + 3 + i]) + ": shape " + c10::str(c10::IntArrayRef(array.dims)) +
                 ", the program takes " + c10::str(c10::IntArrayRef(want.sizes)));
        given.push_back(at::from_blob(const_cast<float *>(array.data.data()), array.dims, at::kFloat).clone());
    }

    std::vector<double> runMs;
    std::string firstCalls, firstLaunches;
    at::Tensor result;
    for (int r = 0; r < runs; ++r) {
        Env env = constants;
        for (int i = 0; i < inputs; ++i)
            env[program.inputs[i].name] = {given[i].to(device)};

        synchronize(device);
        const auto runStart = std::chrono::steady_clock::now();
        for (const auto &node : program.nodes)
            runNode(node, env);
        result = tensorOf(env, program.output, "output");
        synchronize(device);
        runMs.push_back(msSince(runStart));

        if (r == 0) {
            firstCalls = counts(calls);
            firstLaunches = counts(launches);
        }
    }

    if (result.scalar_type() != at::kFloat)
        fail("the program's output is " + std::string(c10::toString(result.scalar_type())) +
             ": the driver writes f32");

    auto host = result.to(at::kCPU).contiguous();
    saveNpy(outputPath, host.sizes().vec(), host.data_ptr<float>());

    std::string times;
    for (double ms : runMs)
        times += (times.empty() ? "" : ", ") + std::to_string(ms);

    std::fprintf(stderr, "engine_driver: wrote %s\n", outputPath.c_str());
    std::fprintf(stderr,
                 "engine_driver: report {\"device\": \"%s\", \"nodes\": %zu, \"constants\": %zu, \"calls\": %s, "
                 "\"launches\": %s, \"load_ms\": %.6f, \"run_ms\": [%s]}\n",
                 program.device.c_str(), program.nodes.size(), program.constants.size(), firstCalls.c_str(),
                 firstLaunches.c_str(), loadMs, times.c_str());
    return 0;
}

}  // namespace

int main(int argc, char **argv)
{
    try {
        return run(argc, argv);
    } catch (const std::exception &e) {
        std::fprintf(stderr, "engine_driver: %s\n", e.what());
        return 1;
    }
}
