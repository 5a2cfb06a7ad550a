// The C ABI of the PyTorch port (dlimgedit_tpu_torch): the dlimg_Api
// function table.
//
// A copy of the JAX package's native/src/capi.cpp in its embedded-interpreter
// mode. The table marshals pointers and errors; every call that needs a
// model goes to the port's bridge, dlimgedit_tpu_torch.native_bridge,
// through an embedded CPython interpreter. The bridge runs the port's
// PyTorch runtime: CUDA graphs and the port's kernels on cuda:0 for
// dlimg_gpu, PyTorch's CPU kernels for dlimg_cpu (backend dlimg_gpu
// without a CUDA device is an error, never the CPU).
//
// Error model mirrors the reference (dlimgedit.cpp:26-40): every fallible
// entry traps exceptions into an error code + thread-local message.
//
// Works both as a standalone embedder (starts the interpreter on first
// use) and when loaded into an existing Python process (ctypes). A
// standalone host starts the interpreter that built the library:
// native_build.py bakes that interpreter's sys.executable in as
// DLIMG_PYTHON_EXECUTABLE and the library gives it to Python as its
// program name, so Python finds its prefix, and a virtual environment's
// pyvenv.cfg, from there and not from the host executable's path. The
// directory that holds the dlimgedit_tpu_torch package (DLIMG_PACKAGE_ROOT)
// is appended to sys.path. PYTHONPATH and PYTHONHOME are honoured as usual.
//
// Python-free serving mode: with DLIMG_PJRT_BUNDLE set to a bundle written
// by the port's exporter (python -m dlimgedit_tpu_torch.tools.aot_export
// --program serving), create_environment, process, compute_mask(s) and
// compute_mask_batch of the bundle's variant (MobileSAM or a SAM ViT;
// compute_mask_batch through the bundle's batch programs where it has
// them), generate_masks (its serve_amg programs, --amg) and
// segment_objects (its BiRefNet programs, --birefnet), with the encoders
// and BiRefNet's gathers in int8 where the bundle's quant row says so
// (--quantize, --quantize-activations, --int8-deform), run through the
// port's serving library,
// libdlimgedit_tpu_torch_serving.so (torch_backend.hpp: C++ on libtorch,
// CUDA graphs and the port's kernels on cuda:0), which this library
// dlopens from its own directory, as the JAX package's library dlopens
// its PJRT plugin. Nothing then starts the interpreter: load_image and
// save_image keep to the native codecs, and a call the bundle has no
// program for fails, naming the exporter's option that writes it. The
// variable keeps the JAX package's name, so a host configured for either
// library works with the other's; a JAX bundle (plugin_path.txt, .pjrt
// programs) is refused with a message that names the port's exporter.
// Backend 1 is cuda:0 and fails without CUDA; backend 0 is the CPU.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlimgedit/detail/dlimgedit.h>

#include <dlfcn.h>

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <mutex>
#include <string>
#include <vector>

#include "bundle.hpp"
#include "codecs.hpp"
#include "torch_backend.hpp"

// csrc/hostops.cpp (compiled into this library): the channel-map pack
// shared with the Python path, and the box-filter mask resize
// (image/resize.py resize_mask's counterpart, within one grey level).
extern "C" void dlimg_hostops_pack_rgb(const uint8_t* src,
                                       int64_t src_stride, int h, int w,
                                       int src_c, int m0, int m1, int m2,
                                       uint8_t* dst, int64_t dst_stride,
                                       int threads);
extern "C" void dlimg_hostops_resize_mask_box(const uint8_t* src, int src_h,
                                              int src_w, int64_t src_stride,
                                              uint8_t* dst, int dst_h,
                                              int dst_w, int64_t dst_stride);

#ifndef DLIMG_PYTHON_EXECUTABLE
#error "build with native_build.py: it defines DLIMG_PYTHON_EXECUTABLE"
#endif
#ifndef DLIMG_PACKAGE_ROOT
#error "build with native_build.py: it defines DLIMG_PACKAGE_ROOT"
#endif

namespace {

char const kBridge[] = "dlimgedit_tpu_torch.native_bridge";
char const kServingLibrary[] = "libdlimgedit_tpu_torch_serving.so";

thread_local std::string g_last_error;

void set_error(std::string msg) { g_last_error = std::move(msg); }

char const* serving_bundle() { return std::getenv("DLIMG_PJRT_BUNDLE"); }

// Exception -> error-code bridge (the reference's try_, dlimgedit.cpp:31-40):
// nothing may throw across the extern-C function table — a bad_alloc in a
// codec would otherwise terminate the embedding process.
template <typename F>
dlimg_Result try_(F&& f) {
    try {
        return f();
    } catch (std::exception const& e) {
        set_error(e.what());
        return dlimg_error;
    } catch (...) {
        set_error("unknown C++ exception");
        return dlimg_error;
    }
}

// ---------------------------------------------------------------------------
// Embedded interpreter management
// ---------------------------------------------------------------------------

// The current Python exception as a string (the exception is cleared).
std::string fetch_py_error() {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    PyObject* s = value ? PyObject_Str(value) : nullptr;
    std::string msg = s && PyUnicode_Check(s) ? PyUnicode_AsUTF8(s)
                                              : "unknown Python error";
    Py_XDECREF(s);
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    return msg;
}

struct PyRuntime {
    PyObject* bridge = nullptr;  // dlimgedit_tpu_torch.native_bridge module
    bool owns_interpreter = false;
    std::string init_error;      // why ensure() failed, for every thread

    static PyRuntime& get() {
        static PyRuntime rt;
        return rt;
    }

    // Start the interpreter that built this library (see the head of this
    // file); the host's signals stay the host's, as Py_InitializeEx(0).
    bool start_interpreter() {
        PyConfig config;
        PyConfig_InitPythonConfig(&config);
        config.install_signal_handlers = 0;
        PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                              DLIMG_PYTHON_EXECUTABLE);
        if (!PyStatus_Exception(st))
            st = Py_InitializeFromConfig(&config);
        PyConfig_Clear(&config);
        if (PyStatus_Exception(st)) {
            init_error = std::string("starting the Python interpreter ") +
                         DLIMG_PYTHON_EXECUTABLE + " failed: " +
                         (st.err_msg ? st.err_msg : "unknown error");
            return false;
        }
        owns_interpreter = true;
        PyObject* path = PySys_GetObject("path");  // borrowed
        PyObject* root = PyUnicode_FromString(DLIMG_PACKAGE_ROOT);
        if (!path || !root || PyList_Append(path, root) != 0) {
            Py_XDECREF(root);
            init_error = "extending sys.path failed: " + fetch_py_error();
            return false;
        }
        Py_DECREF(root);
        return true;
    }

    bool ensure() {
        static std::once_flag once;
        static bool ok = false;
        std::call_once(once, [this] {
            if (!Py_IsInitialized()) {
                if (!start_interpreter()) {
                    // A failed start leaves the GIL with this thread, if
                    // the interpreter came up at all: give it back.
                    if (Py_IsInitialized())
                        PyEval_SaveThread();
                    return;
                }
            }
            PyGILState_STATE gil = PyGILState_Ensure();
            bridge = PyImport_ImportModule(kBridge);
            if (!bridge)
                init_error = std::string("failed to import ") + kBridge +
                             ": " + fetch_py_error();
            PyGILState_Release(gil);
            if (owns_interpreter) {
                // Release the GIL acquired by Py_InitializeFromConfig so
                // other threads (and PyGILState_Ensure below) can take it.
                // A host process that had Python already keeps its own.
                PyEval_SaveThread();
            }
            ok = bridge != nullptr;
        });
        if (!ok)
            set_error(init_error);
        return ok;
    }
};

struct Gil {
    PyGILState_STATE state;
    Gil() : state(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(state); }
};

// Capture the current Python exception into last_error.
void capture_py_error() { set_error(fetch_py_error()); }

// Call bridge.<fn>(args...) -> new reference or nullptr (error captured).
PyObject* bridge_call(char const* fn, PyObject* args /* steals */) {
    PyRuntime& rt = PyRuntime::get();
    PyObject* callable = PyObject_GetAttrString(rt.bridge, fn);
    if (!callable) {
        Py_XDECREF(args);
        capture_py_error();
        return nullptr;
    }
    PyObject* result = PyObject_CallObject(callable, args);
    Py_DECREF(callable);
    Py_XDECREF(args);
    if (!result) capture_py_error();
    return result;
}

}  // namespace

// ---------------------------------------------------------------------------
// Handles (complete the opaque types from the header, at global scope)
// ---------------------------------------------------------------------------

struct dlimg_Environment_ {
    PyObject* obj = nullptr;  // the bridge's Environment (embedded mode)
    void* serving = nullptr;  // the serving library's backend (serving mode)
    dlimg_bundle::Index index;  // the bundle's serving.txt (serving mode)
};
struct dlimg_Segmentation_ {
    PyObject* obj = nullptr;  // the bridge's Segmentation
    int width = 0;
    int height = 0;
    // Serving mode: the embedding stays on the device.
    void* serving = nullptr;
    void* emb = nullptr;
    int bucket = 0;
    double scale = 1.0;  // double: image/resize.py's Python-float rounding
    int crop_h = 0;
    int crop_w = 0;
    int amg_masks = 0;  // the bundle's serve_amg winners K (0: no --amg)
};

namespace {

// ---------------------------------------------------------------------------
// Python-free serving mode (DLIMG_PJRT_BUNDLE; see the head of this file)
// ---------------------------------------------------------------------------

// libdlimgedit_tpu_torch_serving.so from this library's directory, loaded
// once per process; its table or nullptr (the reason in last_error).
struct ServingLibrary {
    dlimg_serving_api const* api = nullptr;
    std::string error;

    static ServingLibrary& get() {
        static ServingLibrary lib;
        return lib;
    }

    bool ensure() {
        static std::once_flag once;
        std::call_once(once, [this] {
            Dl_info info{};
            if (!dladdr(reinterpret_cast<void*>(&serving_bundle), &info) ||
                !info.dli_fname) {
                error = "cannot find the directory of the port's C library";
                return;
            }
            std::string dir = info.dli_fname;
            dir = dir.substr(0, dir.rfind('/') + 1);
            std::string path = dir + kServingLibrary;
            void* lib = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
            if (!lib) {
                char const* why = dlerror();
                error = "loading " + path + " failed (" +
                        std::string(why ? why : "unknown") +
                        "): build it with python -m "
                        "dlimgedit_tpu_torch.native_build --serving";
                return;
            }
            auto init = reinterpret_cast<dlimg_serving_init_fn>(
                dlsym(lib, "dlimg_serving_init"));
            dlimg_serving_api const* table = init ? init() : nullptr;
            if (!table || table->abi != DLIMG_SERVING_ABI) {
                error = path + " is not a serving library of this build "
                        "(no dlimg_serving_init of ABI " +
                        std::to_string(DLIMG_SERVING_ABI) + ")";
                return;
            }
            api = table;
        });
        if (!api) set_error(error);
        return api != nullptr;
    }
};

dlimg_serving_api const& serving() { return *ServingLibrary::get().api; }

// A serving-library call that failed: its message into last_error.
dlimg_Result serving_error(std::string const& what) {
    set_error(what + ": " + serving().last_error());
    return dlimg_error;
}

// Channel-index maps: types.py RGB_CHANNEL_MAP by the ABI's channel code.
void rgb_map(int channels, int* c, int m[3]) {
    switch (channels) {
        case 1: *c = 1; m[0] = m[1] = m[2] = 0; break;           // mask
        case 3: *c = 3; m[0] = 0; m[1] = 1; m[2] = 2; break;     // rgb
        case 4: *c = 4; m[0] = 0; m[1] = 1; m[2] = 2; break;     // rgba
        case 5: *c = 4; m[0] = 2; m[1] = 1; m[2] = 0; break;     // bgra
        default: *c = 4; m[0] = 1; m[1] = 2; m[2] = 3; break;    // argb
    }
}

dlimg_serving_arg host_arg(void const* data, std::vector<int64_t> const& dims,
                           char const* dtype) {
    return dlimg_serving_arg{data,    dims.data(), int(dims.size()),
                             dtype,   nullptr,     nullptr,
                             nullptr};
}

// The image packed into the embed program's canvas (the bucket's top-left
// corner), by the serving library under its lock: a canvas is one buffer
// per program, shared by every thread. It is not zeroed between calls:
// the resample matrices give every pixel outside the image zero weight
// (ops/preprocess.py's pooled canvases rely on the same).
struct CanvasPack {
    dlimg_ImageView const* img;
    int64_t stride;
    int channels;
    int map[3];
    int bucket;
};

void pack_canvas(void* ctx, void* dst) {
    auto const* c = static_cast<CanvasPack const*>(ctx);
    dlimg_hostops_pack_rgb(c->img->pixels, c->stride, c->img->height,
                           c->img->width, c->channels, c->map[0], c->map[1],
                           c->map[2], static_cast<uint8_t*>(dst),
                           int64_t(c->bucket) * 3, 0);
}

// Segmentation.process: the smallest exported bucket that holds the image
// (ops/preprocess.py pick_bucket over the bundle's buckets), the
// resize-longest-side extent (image/resize.py), the native pack, then the
// embed program; its embedding stays on the device.
dlimg_Result serving_process(dlimg_Segmentation* out,
                             dlimg_ImageView const* img,
                             dlimg_Environment env) {
    auto const& api = serving();
    void* be = env->serving;
    int const w = img->width, h = img->height;
    int bucket = 0;
    for (int i = 0, n = api.bucket_count(be); i < n; ++i) {
        int b = api.bucket(be, i);
        if (std::max(w, h) <= b && (bucket == 0 || b < bucket)) bucket = b;
    }
    if (bucket == 0) {
        set_error("process: image " + std::to_string(w) + "x" +
                  std::to_string(h) + " exceeds every canvas bucket of the "
                  "serving bundle (export it with a larger --buckets)");
        return dlimg_error;
    }
    double scale = double(api.image_size(be)) / double(std::max(w, h));
    int tw = int(w * scale + 0.5);
    int th = int(h * scale + 0.5);
    std::string name = "serve_embed_" + std::string(api.variant(be)) + "_" +
                       std::to_string(bucket);
    // Packed straight into the program's canvas: on the card its pinned
    // staging buffer (ops/preprocess.py packs into pinned memory too).
    CanvasPack pack{img, 0, 0, {0, 0, 0}, bucket};
    rgb_map(img->channels, &pack.channels, pack.map);
    pack.stride = img->stride ? img->stride : int64_t(w) * pack.channels;
    int32_t sizes[4] = {h, w, th, tw};
    std::vector<int64_t> canvas_dims = {bucket, bucket, 3}, size_dims = {4};
    dlimg_serving_arg args[2] = {host_arg(nullptr, canvas_dims, "uint8"),
                                 host_arg(sizes, size_dims, "int32")};
    args[0].fill = pack_canvas;
    args[0].fill_ctx = &pack;
    void* outs[4] = {};
    int n_outs = 0;
    if (api.run(be, name.c_str(), args, 2, outs, 4, &n_outs) != 0)
        return serving_error("process");
    if (n_outs != 1) {
        for (int i = 0; i < n_outs; ++i) api.release(be, outs[i]);
        set_error(name + ": " + std::to_string(n_outs) + " outputs, expected "
                  "the embedding alone (stale or mismatched bundle)");
        return dlimg_error;
    }
    auto* seg = new dlimg_Segmentation_{};
    seg->width = w;
    seg->height = h;
    seg->serving = be;
    seg->emb = outs[0];
    seg->bucket = bucket;
    seg->scale = scale;
    seg->crop_h = th;
    seg->crop_w = tw;
    seg->amg_masks = env->index.amg_masks;
    *out = seg;
    return dlimg_success;
}

// pack_mask_bits rows (MSB first) of a bucket canvas -> an (h, w) 0/255
// mask (Segmentation._unpack), eight pixels a table lookup.
void unpack_mask(uint8_t const* packed, int bucket, int h, int w,
                 uint8_t* dst) {
    static auto const table = [] {
        std::vector<uint8_t> t(256 * 8);
        for (int b = 0; b < 256; ++b)
            for (int k = 0; k < 8; ++k)
                t[b * 8 + k] = (b >> (7 - k)) & 1 ? 255 : 0;
        return t;
    }();
    int row_bytes = bucket / 8;
    for (int y = 0; y < h; ++y) {
        uint8_t const* row = packed + size_t(y) * row_bytes;
        uint8_t* out = dst + size_t(y) * w;
        int x = 0;
        for (; x + 8 <= w; x += 8)
            std::memcpy(out + x, &table[size_t(row[x >> 3]) * 8], 8);
        for (; x < w; ++x) out[x] = table[size_t(row[x >> 3]) * 8 + (x & 7)];
    }
}

// Segmentation._prompt_arrays: point -> (p, 1), (0, 0, -1); box ->
// (tl, 2), (br, 3); coordinates through image/resize.py transform_point.
void encode_prompt(double scale, int const* v, bool is_region,
                   float pts[4], float lbl[2]) {
    auto tp = [&](int x) { return float(int(x * scale + 0.5)); };
    if (is_region) {
        pts[0] = tp(v[0]);
        pts[1] = tp(v[1]);
        pts[2] = tp(v[2]);
        pts[3] = tp(v[3]);
        lbl[0] = 2.0f;
        lbl[1] = 3.0f;
    } else {
        pts[0] = tp(v[0]);
        pts[1] = tp(v[1]);
        pts[2] = 0.0f;
        pts[3] = 0.0f;
        lbl[0] = 1.0f;
        lbl[1] = -1.0f;
    }
}

// Decode program `name` on `rows` prompts (pts: rows x 2 x 2, lbl: rows x
// 2) against the segmentation's embedding, which gives `produced` masks and
// IoUs; the first `n_masks` masks unpacked into out_masks and their IoUs
// into out_accuracies (if given).
dlimg_Result serving_decode(dlimg_Segmentation seg, std::string const& name,
                            char const* what, float const* pts,
                            float const* lbl, int rows, int produced,
                            int n_masks, uint8_t* const* out_masks,
                            float* out_accuracies) {
    auto const& api = serving();
    void* be = seg->serving;
    int32_t sizes[4] = {seg->height, seg->width, seg->crop_h, seg->crop_w};
    std::vector<int64_t> pts_dims = {rows, 2, 2}, lbl_dims = {rows, 2},
                         size_dims = {4};
    dlimg_serving_arg args[4] = {
        dlimg_serving_arg{nullptr, nullptr, 0, nullptr, seg->emb, nullptr,
                          nullptr},
        host_arg(pts, pts_dims, "float32"), host_arg(lbl, lbl_dims, "float32"),
        host_arg(sizes, size_dims, "int32")};
    void* outs[4] = {};
    int n_outs = 0;
    if (api.run(be, name.c_str(), args, 4, outs, 4, &n_outs) != 0)
        return serving_error(what);
    size_t const mask_bytes = size_t(seg->bucket) * (size_t(seg->bucket) / 8);
    std::vector<uint8_t> packed(size_t(produced) * mask_bytes);
    std::vector<float> iou(produced);
    bool ok = n_outs == 2 &&
              api.fetch(be, outs[1], iou.data(), iou.size() * sizeof(float)) ==
                  0 &&
              api.fetch(be, outs[0], packed.data(), packed.size()) == 0;
    std::string why = n_outs == 2 ? std::string(api.last_error())
                                  : name + ": " + std::to_string(n_outs) +
                                        " outputs, expected 2 (stale or "
                                        "mismatched bundle)";
    for (int i = 0; i < n_outs; ++i) api.release(be, outs[i]);
    if (!ok) {
        set_error(std::string(what) + ": " + why);
        return dlimg_error;
    }
    for (int i = 0; i < n_masks; ++i) {
        unpack_mask(packed.data() + size_t(i) * mask_bytes, seg->bucket,
                    seg->height, seg->width, out_masks[i]);
        if (out_accuracies) out_accuracies[i] = iou[i];
    }
    return dlimg_success;
}

std::string program_name(dlimg_Segmentation seg, std::string const& head) {
    return head + "_" + serving().variant(seg->serving) + "_" +
           std::to_string(seg->bucket);
}

// One prompt through serve_decode (one mask) or serve_decode3 (three masks
// and their accuracies): Segmentation._decode.
dlimg_Result serving_get_mask(dlimg_Segmentation seg, int const* point,
                              int const* region, uint8_t* const* out_masks,
                              float* out_accuracies) {
    bool const single = out_masks[1] == nullptr;
    if (!single && !point) {
        set_error("compute_mask: three masks need a point prompt");
        return dlimg_error;
    }
    float pts[4], lbl[2];
    encode_prompt(seg->scale, point ? point : region, point == nullptr, pts,
                  lbl);
    int const n_masks = single ? 1 : 3;
    return serving_decode(
        seg, program_name(seg, single ? "serve_decode" : "serve_decode3"),
        "compute_mask", pts, lbl, 1, n_masks, n_masks, out_masks,
        out_accuracies);
}

// compute_mask_batch through the bundle's serve_decode_batch<N> programs
// (the JAX package's pjrt_compute_mask_batch): the smallest exported size
// that covers what is left of the request, else the largest, and loop;
// slots past the request hold the (-1, -1) "no prompt" labels. Each mask
// is compute_mask's for its prompt (runtime/segmentation.py
// _build_batch_decode_fn decodes each prompt at batch 1). A bundle
// exported without --batch-sizes takes each prompt through serve_decode.
dlimg_Result serving_compute_mask_batch(dlimg_Segmentation seg,
                                        int const* prompts,
                                        int const* is_region, int n,
                                        uint8_t* const* out_masks,
                                        float* out_accuracies) {
    auto const& api = serving();
    std::vector<int> sizes_avail;
    for (int i = 0, k = api.batch_count(seg->serving); i < k; ++i)
        sizes_avail.push_back(api.batch_size(seg->serving, i));
    if (sizes_avail.empty()) {
        for (int i = 0; i < n; ++i) {
            int const* v = prompts + size_t(i) * 4;
            uint8_t* one[3] = {out_masks[i], nullptr, nullptr};
            dlimg_Result r = serving_get_mask(
                seg, is_region[i] ? nullptr : v, is_region[i] ? v : nullptr,
                one, out_accuracies ? out_accuracies + i : nullptr);
            if (r != dlimg_success) return r;
        }
        return dlimg_success;
    }
    int done = 0;
    while (done < n) {
        int const want = n - done;
        int nb = sizes_avail.back();
        for (int s : sizes_avail)
            if (s >= want) {
                nb = s;
                break;
            }
        int const take = std::min(want, nb);
        std::vector<float> pts(size_t(nb) * 4, 0.0f);
        std::vector<float> lbl(size_t(nb) * 2, -1.0f);  // padding: no prompt
        for (int i = 0; i < take; ++i)
            encode_prompt(seg->scale, prompts + size_t(done + i) * 4,
                          is_region[done + i] != 0, pts.data() + 4 * i,
                          lbl.data() + 2 * i);
        dlimg_Result r = serving_decode(
            seg, program_name(seg, "serve_decode_batch" + std::to_string(nb)),
            "compute_mask_batch", pts.data(), lbl.data(), nb, nb, take,
            out_masks + done, out_accuracies ? out_accuracies + done : nullptr);
        if (r != dlimg_success) return r;
        done += take;
    }
    return dlimg_success;
}

// generate_masks through the bundle's serve_amg program (the JAX
// package's pjrt_generate_masks): the thresholds {iou, stability, nms, 0,
// 1, 0} (no area filter and no region refinement, as the C ABI's), one
// graph on the card; the scores first, then the packed masks. The count is
// the leading scores above 0 (sorted descending; the rest are pads or
// masks the decoder rated <= 0), at most max_out.
dlimg_Result serving_generate_masks(dlimg_Segmentation seg,
                                    float const* thresholds, int max_out,
                                    uint8_t* const* out_masks,
                                    float* out_accuracies, int* out_count) {
    auto const& api = serving();
    void* be = seg->serving;
    int const K = seg->amg_masks;
    if (K == 0) {
        set_error("generate_masks: the serving bundle was exported without "
                  "--amg (re-run python -m dlimgedit_tpu_torch.tools."
                  "aot_export --program serving --amg grid:max_masks)");
        return dlimg_error;
    }
    float const thr[6] = {thresholds[0], thresholds[1], thresholds[2],
                          0.0f, 1.0f, 0.0f};
    int32_t sizes[4] = {seg->height, seg->width, seg->crop_h, seg->crop_w};
    std::vector<int64_t> size_dims = {4}, thr_dims = {6};
    dlimg_serving_arg args[3] = {
        dlimg_serving_arg{nullptr, nullptr, 0, nullptr, seg->emb, nullptr,
                          nullptr},
        host_arg(sizes, size_dims, "int32"), host_arg(thr, thr_dims, "float32")};
    std::string const name = program_name(seg, "serve_amg");
    void* outs[4] = {};
    int n_outs = 0;
    if (api.run(be, name.c_str(), args, 3, outs, 4, &n_outs) != 0)
        return serving_error("generate_masks");
    size_t const mask_bytes = size_t(seg->bucket) * (size_t(seg->bucket) / 8);
    std::vector<float> score(K);
    std::vector<uint8_t> packed(size_t(K) * mask_bytes);
    bool ok = n_outs == 4 &&
              api.fetch(be, outs[1], score.data(),
                        score.size() * sizeof(float)) == 0 &&
              api.fetch(be, outs[0], packed.data(), packed.size()) == 0;
    std::string why = n_outs == 4 ? std::string(api.last_error())
                                  : name + ": " + std::to_string(n_outs) +
                                        " outputs, expected 4 (stale or "
                                        "mismatched bundle)";
    for (int i = 0; i < n_outs; ++i) api.release(be, outs[i]);
    if (!ok) {
        set_error("generate_masks: " + why);
        return dlimg_error;
    }
    int n = 0;
    while (n < K && n < max_out && score[n] > 0.0f) ++n;
    for (int i = 0; i < n; ++i) {
        unpack_mask(packed.data() + size_t(i) * mask_bytes, seg->bucket,
                    seg->height, seg->width, out_masks[i]);
        if (out_accuracies) out_accuracies[i] = score[i];
    }
    *out_count = n;
    return dlimg_success;
}

// segment_objects through the bundle's BiRefNet programs (the JAX
// package's pjrt_segment_objects; runtime/birefnet.py birefnet_segment):
// high_res when the longer side exceeds 1536 px, the smallest bucket of
// that kind that holds the image, else of any kind; the canvas packed by
// the serving library's fill under its lock; the (S, S) mask at the
// model's resolution, resized to the image's extent with the box filter.
dlimg_Result serving_segment_objects(dlimg_ImageView const* img,
                                     uint8_t* out_mask,
                                     dlimg_Environment env) {
    auto const& api = serving();
    void* be = env->serving;
    auto const& progs = env->index.birefnet;
    if (progs.empty()) {
        set_error("segment_objects: the serving bundle has no BiRefNet "
                  "program (re-run python -m dlimgedit_tpu_torch.tools."
                  "aot_export --program serving --birefnet general:1024)");
        return dlimg_error;
    }
    int const w = img->width, h = img->height, side = std::max(w, h);
    std::string const want = side > 1536 ? "high_res" : "general";
    dlimg_bundle::BirefProgram const* best = nullptr;
    for (int any = 0; any < 2 && !best; ++any)
        for (auto const& p : progs)
            if ((any || p.kind == want) && side <= p.bucket &&
                (!best || p.bucket < best->bucket))
                best = &p;
    if (!best) {
        set_error("segment_objects: image " + std::to_string(w) + "x" +
                  std::to_string(h) + " exceeds every BiRefNet bucket of the "
                  "serving bundle (export it with a larger --birefnet "
                  "kind:bucket)");
        return dlimg_error;
    }
    CanvasPack pack{img, 0, 0, {0, 0, 0}, best->bucket};
    rgb_map(img->channels, &pack.channels, pack.map);
    pack.stride = img->stride ? img->stride : int64_t(w) * pack.channels;
    int32_t sizes[2] = {h, w};
    std::vector<int64_t> canvas_dims = {best->bucket, best->bucket, 3},
                         size_dims = {2};
    dlimg_serving_arg args[2] = {host_arg(nullptr, canvas_dims, "uint8"),
                                 host_arg(sizes, size_dims, "int32")};
    args[0].fill = pack_canvas;
    args[0].fill_ctx = &pack;
    std::string const name = "serve_birefnet_" + best->kind + "_" +
                             std::to_string(best->bucket);
    void* outs[2] = {};
    int n_outs = 0;
    if (api.run(be, name.c_str(), args, 2, outs, 2, &n_outs) != 0)
        return serving_error("segment_objects");
    int const S = best->resolution;
    std::vector<uint8_t> model_mask(size_t(S) * S);
    bool ok = n_outs == 1 && api.fetch(be, outs[0], model_mask.data(),
                                       model_mask.size()) == 0;
    std::string why = n_outs == 1 ? std::string(api.last_error())
                                  : name + ": " + std::to_string(n_outs) +
                                        " outputs, expected the mask alone "
                                        "(stale or mismatched bundle)";
    for (int i = 0; i < n_outs; ++i) api.release(be, outs[i]);
    if (!ok) {
        set_error("segment_objects: " + why);
        return dlimg_error;
    }
    dlimg_hostops_resize_mask_box(model_mask.data(), S, S, S, out_mask, h, w,
                                  w);
    return dlimg_success;
}

// ---------------------------------------------------------------------------
// API entries
// ---------------------------------------------------------------------------

int api_is_backend_supported(dlimg_Backend backend) {
    if (char const* bundle = serving_bundle()) {
        // Answered without starting Python: the bundle's backend, and for
        // the GPU a CUDA device as the serving library sees it.
        try {
            dlimg_bundle::Index index;
            std::string problem = dlimg_bundle::read_index(bundle, &index);
            if (!problem.empty()) {
                set_error(problem);
                return 0;
            }
            if (index.backend != (backend == dlimg_gpu ? "gpu" : "cpu"))
                return 0;
            if (backend == dlimg_cpu) return 1;
            return ServingLibrary::get().ensure() && serving().cuda_available();
        } catch (...) {
            return 0;
        }
    }
    try {
        if (!PyRuntime::get().ensure()) return 0;
        Gil gil;
        PyObject* r = bridge_call("backend_supported",
                                  Py_BuildValue("(i)", int(backend)));
        if (!r) return 0;
        int ok = PyObject_IsTrue(r);
        Py_DECREF(r);
        return ok;
    } catch (...) {
        return 0;
    }
}

dlimg_Result api_create_environment(dlimg_Environment* out,
                                    dlimg_Options const* opts) {
  return try_([&]() -> dlimg_Result {
    if (!out || !opts) {
        set_error("create_environment: invalid arguments (null pointer)");
        return dlimg_error;
    }
    if (char const* bundle = serving_bundle()) {
        // The refusals of what is no bundle of the port's exporter come
        // before the serving library (and libtorch) is loaded.
        dlimg_bundle::Index index;
        std::string problem = dlimg_bundle::read_index(bundle, &index);
        if (!problem.empty()) {
            set_error(problem);
            return dlimg_error;
        }
        if (!ServingLibrary::get().ensure()) return dlimg_error;
        void* be = serving().create(bundle, int(opts->backend));
        if (!be) {
            set_error(std::string("serving bundle ") + bundle + ": " +
                      serving().last_error());
            return dlimg_error;
        }
        auto* env = new dlimg_Environment_{};
        env->serving = be;
        env->index = index;
        *out = env;
        return dlimg_success;
    }
    if (!PyRuntime::get().ensure()) return dlimg_error;
    Gil gil;
    PyObject* r = bridge_call(
        "create_environment",
        Py_BuildValue("(is)", int(opts->backend),
                      opts->model_directory ? opts->model_directory : "models"));
    if (!r) return dlimg_error;
    auto* env = new dlimg_Environment_{};
    env->obj = r;
    *out = env;
    return dlimg_success;
  });
}

void api_destroy_environment(dlimg_Environment env) {
    if (!env) return;
    if (env->obj) {
        Gil gil;
        Py_XDECREF(env->obj);
    }
    if (env->serving) serving().destroy(env->serving);
    delete env;
}

dlimg_Result api_process(dlimg_Segmentation* out, dlimg_ImageView const* img,
                         dlimg_Environment env) {
  return try_([&]() -> dlimg_Result {
    if (!out || !img || !env) {  // a null HANDLE is an error, not a segfault
        set_error("process: invalid arguments (null environment/image)");
        return dlimg_error;
    }
    if (env->serving) return serving_process(out, img, env);
    Gil gil;
    PyObject* r = bridge_call(
        "process",
        Py_BuildValue("(OKiiii)", env->obj, (unsigned long long)(uintptr_t)img->pixels,
                      img->width, img->height, img->channels, img->stride));
    if (!r) return dlimg_error;
    auto* seg = new dlimg_Segmentation_{};
    seg->obj = r;
    seg->width = img->width;
    seg->height = img->height;
    *out = seg;
    return dlimg_success;
  });
}

dlimg_Result api_get_mask(dlimg_Segmentation seg, int const* point,
                          int const* region, uint8_t** out_masks,
                          float* out_accuracies) {
  return try_([&]() -> dlimg_Result {
    if (!seg || !out_masks || (!point && !region)) {
        set_error("compute_mask: invalid arguments (null handle/outputs)");
        return dlimg_error;
    }
    if (seg->serving)
        return serving_get_mask(seg, point, region, out_masks, out_accuracies);
    Gil gil;
    PyObject* py_point = point ? Py_BuildValue("(ii)", point[0], point[1])
                               : Py_NewRef(Py_None);
    PyObject* py_region =
        region ? Py_BuildValue("(iiii)", region[0], region[1], region[2],
                               region[3])
               : Py_NewRef(Py_None);
    PyObject* ptrs = Py_BuildValue(
        "[KKK]", (unsigned long long)(uintptr_t)out_masks[0],
        (unsigned long long)(uintptr_t)out_masks[1],
        (unsigned long long)(uintptr_t)out_masks[2]);
    PyObject* r = bridge_call(
        "compute_mask",
        Py_BuildValue("(ONNNK)", seg->obj, py_point, py_region, ptrs,
                      (unsigned long long)(uintptr_t)out_accuracies));
    if (!r) return dlimg_error;
    Py_DECREF(r);
    return dlimg_success;
  });
}

dlimg_Result api_compute_mask_batch(dlimg_Segmentation seg,
                                    int const* prompts,
                                    int const* is_region, int n,
                                    uint8_t* const* out_masks,
                                    float* out_accuracies) {
  return try_([&]() -> dlimg_Result {
    if (!seg || !prompts || !is_region || n <= 0 || !out_masks) {
        set_error("compute_mask_batch: invalid arguments");
        return dlimg_error;
    }
    if (seg->serving)
        return serving_compute_mask_batch(seg, prompts, is_region, n,
                                          out_masks, out_accuracies);
    Gil gil;
    PyObject* py_prompts = PyTuple_New(size_t(n) * 4);
    PyObject* py_isreg = PyTuple_New(n);
    PyObject* ptrs = py_prompts && py_isreg ? PyList_New(n) : nullptr;
    if (!ptrs) {
        PyErr_Clear();
        Py_XDECREF(py_prompts);
        Py_XDECREF(py_isreg);
        set_error("compute_mask_batch: allocation failure");
        return dlimg_error;
    }
    bool ok = true;
    for (int i = 0; ok && i < 4 * n; ++i) {
        PyObject* v = PyLong_FromLong(prompts[i]);
        ok = v != nullptr;
        if (ok) PyTuple_SET_ITEM(py_prompts, i, v);
    }
    for (int i = 0; ok && i < n; ++i) {
        PyObject* v = PyLong_FromLong(is_region[i]);
        PyObject* p = v ? PyLong_FromUnsignedLongLong(
                              (unsigned long long)(uintptr_t)out_masks[i])
                        : nullptr;
        ok = p != nullptr;
        if (!ok) {
            Py_XDECREF(v);
        } else {
            PyTuple_SET_ITEM(py_isreg, i, v);
            PyList_SetItem(ptrs, i, p);
        }
    }
    if (!ok) {
        PyErr_Clear();
        Py_DECREF(py_prompts);
        Py_DECREF(py_isreg);
        Py_DECREF(ptrs);
        set_error("compute_mask_batch: allocation failure");
        return dlimg_error;
    }
    PyObject* r = bridge_call(
        "compute_mask_batch",
        Py_BuildValue("(ONNiNK)", seg->obj, py_prompts, py_isreg, n, ptrs,
                      (unsigned long long)(uintptr_t)out_accuracies));
    if (!r) return dlimg_error;
    Py_DECREF(r);
    return dlimg_success;
  });
}

dlimg_Result api_generate_masks(dlimg_Segmentation seg,
                                float const* thresholds, int max_masks,
                                uint8_t* const* out_masks,
                                float* out_accuracies, int* out_count) {
  return try_([&]() -> dlimg_Result {
    if (!seg || !thresholds || !out_masks || !out_count || max_masks <= 0) {
        set_error("generate_masks: invalid arguments");
        return dlimg_error;
    }
    *out_count = 0;
    if (seg->serving)
        return serving_generate_masks(seg, thresholds, max_masks, out_masks,
                                      out_accuracies, out_count);
    Gil gil;
    PyObject* ptrs = PyList_New(max_masks);
    if (!ptrs) {
        PyErr_Clear();
        set_error("generate_masks: allocation failure");
        return dlimg_error;
    }
    for (int i = 0; i < max_masks; ++i) {
        PyObject* v = PyLong_FromUnsignedLongLong(
            (unsigned long long)(uintptr_t)out_masks[i]);
        if (!v) {  // PyList_SetItem(NULL) would store a hole / crash later
            PyErr_Clear();
            Py_DECREF(ptrs);
            set_error("generate_masks: allocation failure");
            return dlimg_error;
        }
        PyList_SetItem(ptrs, i, v);
    }
    PyObject* r = bridge_call(
        "generate_masks",
        Py_BuildValue("(OfffiNK)", seg->obj, thresholds[0], thresholds[1],
                      thresholds[2], max_masks, ptrs,
                      (unsigned long long)(uintptr_t)out_accuracies));
    if (!r) return dlimg_error;
    *out_count = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    return dlimg_success;
  });
}

void api_get_extent(dlimg_Segmentation seg, int* out_extent) {
    if (!out_extent) return;
    if (!seg) {  // null handle reports a zero extent, not a segfault
        out_extent[0] = out_extent[1] = 0;
        return;
    }
    out_extent[0] = seg->width;
    out_extent[1] = seg->height;
}

void api_destroy_segmentation(dlimg_Segmentation seg) {
    if (!seg) return;
    if (seg->obj) {
        Gil gil;
        Py_XDECREF(seg->obj);
    }
    if (seg->emb) serving().release(seg->serving, seg->emb);
    delete seg;
}

dlimg_Result api_segment_objects(dlimg_ImageView const* img, uint8_t* out_mask,
                                 dlimg_Environment env) {
  return try_([&]() -> dlimg_Result {
    if (!img || !out_mask || !env) {
        set_error("segment_objects: invalid arguments (null handle/image)");
        return dlimg_error;
    }
    if (env->serving) return serving_segment_objects(img, out_mask, env);
    Gil gil;
    PyObject* r = bridge_call(
        "run_segment_objects",
        Py_BuildValue("(OKiiiiK)", env->obj,
                      (unsigned long long)(uintptr_t)img->pixels, img->width,
                      img->height, img->channels, img->stride,
                      (unsigned long long)(uintptr_t)out_mask));
    if (!r) return dlimg_error;
    Py_DECREF(r);
    return dlimg_success;
  });
}

dlimg_Result api_load_image(char const* filepath, int* out_extent,
                            int* out_channels, uint8_t** out_pixels) {
  return try_([&]() -> dlimg_Result {
    // Native codec path first (libpng/libjpeg where the build found them,
    // plus the built-in containers): no Python involved, mirroring the
    // reference's stb layer (src/image.cpp:11-23). The bridge (Pillow)
    // remains the fallback for what the native layer does not handle.
    {
        std::string err;
        int w = 0, h = 0, c = 0;
        uint8_t* px = dlimg_native::load_image(filepath, &w, &h, &c, &err);
        if (px) {
            out_extent[0] = w;
            out_extent[1] = h;
            *out_channels = c;
            *out_pixels = px;
            return dlimg_success;
        }
        if (!err.empty()) {  // recognised format but corrupt/unreadable
            set_error("load_image: " + err);
            return dlimg_error;
        }
    }
    if (serving_bundle()) {
        // Serving mode starts no interpreter: a container the native
        // codecs do not read is an error here.
        set_error("load_image: unrecognised image format (native codecs: "
                  "png/jpeg where built, bmp/tga; the Python codec fallback "
                  "is disabled in serving mode, DLIMG_PJRT_BUNDLE)");
        return dlimg_error;
    }
    if (!PyRuntime::get().ensure()) return dlimg_error;
    Gil gil;
    PyObject* r = bridge_call("load_image", Py_BuildValue("(s)", filepath));
    if (!r) return dlimg_error;
    int w, h, c;
    PyObject* bytes;
    if (!PyArg_ParseTuple(r, "iiiO", &w, &h, &c, &bytes)) {
        capture_py_error();
        Py_DECREF(r);
        return dlimg_error;
    }
    size_t n = size_t(w) * h * c;
    if (!PyBytes_Check(bytes) || size_t(PyBytes_Size(bytes)) < n) {
        set_error("load_image: pixel buffer shorter than width*height*channels");
        Py_DECREF(r);
        return dlimg_error;
    }
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(n));
    if (!buf) {
        set_error("load_image: allocation failed");
        Py_DECREF(r);
        return dlimg_error;
    }
    std::memcpy(buf, PyBytes_AsString(bytes), n);
    Py_DECREF(r);
    out_extent[0] = w;
    out_extent[1] = h;
    *out_channels = c;
    *out_pixels = buf;
    return dlimg_success;
  });
}

dlimg_Result api_save_image(dlimg_ImageView const* img, char const* filepath) {
  return try_([&]() -> dlimg_Result {
    // Native PNG encoder (libpng) for the reference-supported channel
    // orders mask/rgb/rgba (image.cpp:25-35); bgra/argb and libpng-less
    // builds fall through to the bridge (which also rejects bgra/argb,
    // with a descriptive error).
    if (img->channels == 1 || img->channels == 3 || img->channels == 4) {
        std::string err;
        if (dlimg_native::save_png(filepath, img->pixels, img->width,
                                   img->height, img->channels, img->stride,
                                   &err))
            return dlimg_success;
        if (!err.empty()) {
            set_error("save_image: " + err);
            return dlimg_error;
        }
    }
    if (serving_bundle()) {
        set_error(img->channels == 1 || img->channels == 3 ||
                          img->channels == 4
                      ? "save_image: native PNG encoder unavailable (built "
                        "without libpng); the Python codec fallback is "
                        "disabled in serving mode (DLIMG_PJRT_BUNDLE)"
                      : "save_image: unsupported channel order for the "
                        "native PNG encoder (mask/rgb/rgba); the Python codec "
                        "fallback is disabled in serving mode "
                        "(DLIMG_PJRT_BUNDLE)");
        return dlimg_error;
    }
    if (!PyRuntime::get().ensure()) return dlimg_error;
    Gil gil;
    PyObject* r = bridge_call(
        "save_image",
        Py_BuildValue("(Kiiiis)", (unsigned long long)(uintptr_t)img->pixels,
                      img->width, img->height, img->channels, img->stride,
                      filepath));
    if (!r) return dlimg_error;
    Py_DECREF(r);
    return dlimg_success;
  });
}

uint8_t* api_create_image(int width, int height, int channels) {
    int c = channels >= 5 ? 4 : channels;
    return static_cast<uint8_t*>(std::malloc(size_t(width) * height * c));
}

void api_destroy_image(uint8_t const* pixels) {
    std::free(const_cast<uint8_t*>(pixels));
}

char const* api_last_error(void) { return g_last_error.c_str(); }

dlimg_Api const api_table = {
    api_is_backend_supported,
    api_create_environment,
    api_destroy_environment,
    api_process,
    api_get_mask,
    api_get_extent,
    api_destroy_segmentation,
    api_segment_objects,
    api_load_image,
    api_save_image,
    api_create_image,
    api_destroy_image,
    api_last_error,
    api_generate_masks,
    api_compute_mask_batch,
};

}  // namespace

extern "C" DLIMG_API dlimg_Api const* dlimg_init(void) { return &api_table; }
