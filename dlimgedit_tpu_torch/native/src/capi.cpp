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
// The JAX package's PJRT serving mode (DLIMG_PJRT_BUNDLE) has no
// counterpart here: the port's executables are CUDA graphs, which live
// only as long as their process, so there is no exported program to
// serve. With DLIMG_PJRT_BUNDLE set, create_environment fails with a
// message and is_backend_supported reports no backend.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlimgedit/detail/dlimgedit.h>

#include <cstdlib>
#include <cstring>
#include <exception>
#include <mutex>
#include <string>

#include "codecs.hpp"

#ifndef DLIMG_PYTHON_EXECUTABLE
#error "build with native_build.py: it defines DLIMG_PYTHON_EXECUTABLE"
#endif
#ifndef DLIMG_PACKAGE_ROOT
#error "build with native_build.py: it defines DLIMG_PACKAGE_ROOT"
#endif

namespace {

char const kBridge[] = "dlimgedit_tpu_torch.native_bridge";
char const kNoPjrt[] =
    "DLIMG_PJRT_BUNDLE is set, but the PyTorch port has no PJRT serving "
    "route (its executables are CUDA graphs, which live only as long as "
    "their process); unset it to serve through the embedded interpreter";

thread_local std::string g_last_error;

void set_error(std::string msg) { g_last_error = std::move(msg); }

bool pjrt_requested() { return std::getenv("DLIMG_PJRT_BUNDLE") != nullptr; }

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
    PyObject* obj = nullptr;  // the bridge's Environment
};
struct dlimg_Segmentation_ {
    PyObject* obj = nullptr;  // the bridge's Segmentation
    int width = 0;
    int height = 0;
};

namespace {

// ---------------------------------------------------------------------------
// API entries
// ---------------------------------------------------------------------------

int api_is_backend_supported(dlimg_Backend backend) {
    if (pjrt_requested()) {  // answered without starting Python
        set_error(kNoPjrt);
        return 0;
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
    if (pjrt_requested()) {
        set_error(kNoPjrt);
        return dlimg_error;
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
    delete env;
}

dlimg_Result api_process(dlimg_Segmentation* out, dlimg_ImageView const* img,
                         dlimg_Environment env) {
  return try_([&]() -> dlimg_Result {
    if (!out || !img || !env) {  // a null HANDLE is an error, not a segfault
        set_error("process: invalid arguments (null environment/image)");
        return dlimg_error;
    }
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
    delete seg;
}

dlimg_Result api_segment_objects(dlimg_ImageView const* img, uint8_t* out_mask,
                                 dlimg_Environment env) {
  return try_([&]() -> dlimg_Result {
    if (!img || !out_mask || !env) {
        set_error("segment_objects: invalid arguments (null handle/image)");
        return dlimg_error;
    }
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
