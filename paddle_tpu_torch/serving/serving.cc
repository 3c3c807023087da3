// C++ serving shim of the PyTorch port — native predictor API over exported
// models (port of paddle_tpu/serving/serving.cc).
//
// Capability-equivalent of the reference inference C++ API
// (paddle/fluid/inference/api/paddle_api.h PaddlePredictor + PaddleTensor;
// api/analysis_predictor.h:44 AnalysisPredictor::Run :52, ZeroCopyRun :61;
// api/demo_ci standalone consumer): a C++ application links this library,
// loads a model directory exported by
// paddle_tpu_torch.io.inference.save_inference_model (model.pt2 + params),
// and serves it through a flat C ABI.
//
// Architecture: PyTorch is the executor (on the CUDA card, where kernel 4
// runs as the operator paddle_tpu_torch::flash_fwd), reached through an
// embedded CPython interpreter driving
// paddle_tpu_torch.io.inference.InferencePredictor. A directory holding
// only a JAX export (model.stablehlo) is refused by name at create time.
// Input tensors cross the C boundary as memoryviews over the caller's
// buffers (numpy.frombuffer; the predictor copies them to its device);
// outputs are exposed through the buffer protocol and stay valid until the
// next Run — the ZeroCopyTensor lifetime contract.
//
// Flat C ABI (ctypes/C callers both work):
//   ptpu_create(model_dir, sys_path, device) -> handle (check ptpu_ok)
//   ptpu_clone(h)                          -> handle (shares the model)
//   ptpu_ok(h), ptpu_last_error(h)         -> int, const char*
//   ptpu_num_inputs/ptpu_input_name/_rank/_shape/_dtype(h, i)
//   ptpu_run(h, tensors, n)                -> 0 | -1
//   ptpu_num_outputs/_output_rank/_output_shape/_output_dtype/
//   ptpu_output_data/_output_nbytes(h, i)
//   ptpu_destroy(h)
//
// The one difference from the JAX package's ABI is ptpu_create's third
// argument: the device ("cuda", "cuda:1", "cpu"; NULL or "" means the
// card, and without a card create fails — it never drops to the CPU on
// its own). JAX picks its platform through JAX_PLATFORMS instead.
//
// dtype codes (stable, documented for C callers): 0 float32, 1 float64,
// 2 int32, 3 int64, 4 uint8, 5 int8, 6 bool, 7 bfloat16, 8 float16. The
// item sizes come from this file's own table (numpy has no bfloat16): a
// bfloat16 input is handed over as its uint16 bits viewed as
// torch.bfloat16. The predictor returns bfloat16 outputs as float32.
//
// Threading contract (as the reference PaddlePredictor's: one predictor
// per thread, created via Clone): a handle is NOT thread-safe — ptpu_run
// rewrites its output slots. For concurrent serving, ptpu_clone one handle
// per thread; clones share the loaded predictor (its program and weights)
// but own their outputs. Python-driving work serializes on the GIL;
// PyTorch releases it inside its ops, so cloned handles overlap device
// work.
//
// Build (paddle_tpu_torch.serving.build_library, into
// build/paddle_tpu_torch/native/): g++ -O2 -shared -fPIC -std=c++17
// serving.cc -I<python include> — no -lpython: the library runs inside an
// interpreter (ctypes) or a program linked against libpython (demo.cc).

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

const char* kDtypeNames[] = {"float32", "float64", "int32",   "int64",
                             "uint8",   "int8",    "bool",    "bfloat16",
                             "float16"};
const int kItemSize[] = {4, 8, 4, 8, 1, 1, 1, 2, 2};
constexpr int kNumDtypes = 9;
constexpr int kBfloat16 = 7;

int dtype_code(const std::string& name) {
  for (int i = 0; i < kNumDtypes; i++)
    if (name == kDtypeNames[i]) return i;
  return -1;
}

struct Output {
  std::vector<int64_t> shape;
  int dtype = -1;
  PyObject* array = nullptr;  // owned contiguous ndarray keeping data alive
  void* data = nullptr;
  int64_t nbytes = 0;
};

struct Handle {
  PyObject* predictor = nullptr;
  PyObject* np = nullptr;
  PyObject* torch = nullptr;
  std::vector<Output> outputs;
  std::vector<std::string> in_names;
  std::vector<std::vector<int64_t>> in_shapes;
  std::vector<int> in_dtypes;
  std::string error;
};

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

void set_py_error(Handle* h, const char* what) {
  h->error = what;
  if (PyErr_Occurred()) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    if (value) {
      PyObject* s = PyObject_Str(value);
      if (s) {
        h->error += ": ";
        h->error += PyUnicode_AsUTF8(s);
        Py_DECREF(s);
      }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
  }
}

void clear_outputs(Handle* h) {
  for (auto& o : h->outputs) Py_XDECREF(o.array);
  h->outputs.clear();
}

void prepend_sys_path(const char* extra_sys_path) {
  if (!extra_sys_path || !*extra_sys_path) return;
  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  std::string paths(extra_sys_path);
  // inserted at increasing indices, so the caller's order is kept
  Py_ssize_t at = 0;
  size_t start = 0;
  while (start <= paths.size()) {
    size_t sep = paths.find(':', start);
    std::string p = paths.substr(
        start, sep == std::string::npos ? std::string::npos : sep - start);
    if (!p.empty()) {
      PyObject* ps = PyUnicode_FromString(p.c_str());
      PyList_Insert(sys_path, at++, ps);
      Py_DECREF(ps);
    }
    if (sep == std::string::npos) break;
    start = sep + 1;
  }
}

}  // namespace

extern "C" {

typedef struct {
  int dtype;             // kDtypeNames index
  int rank;
  const int64_t* shape;
  const void* data;      // row-major contiguous, read in place
} PtpuTensor;

void* ptpu_create(const char* model_dir, const char* extra_sys_path,
                  const char* device) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    PyEval_SaveThread();  // release the GIL so Gil{} works uniformly
  }
  Gil gil;
  Handle* h = new Handle();
  prepend_sys_path(extra_sys_path);

  h->np = PyImport_ImportModule("numpy");
  h->torch = h->np ? PyImport_ImportModule("torch") : nullptr;
  PyObject* mod = h->torch
      ? PyImport_ImportModule("paddle_tpu_torch.io.inference") : nullptr;
  PyObject* cls =
      mod ? PyObject_GetAttrString(mod, "InferencePredictor") : nullptr;
  if (cls) {
    PyObject* dev = (device && *device) ? PyUnicode_FromString(device)
                                        : (Py_INCREF(Py_None), Py_None);
    h->predictor = PyObject_CallFunction(cls, "sO", model_dir, dev);
    Py_DECREF(dev);
  }
  Py_XDECREF(cls);
  Py_XDECREF(mod);
  if (!h->predictor) {
    set_py_error(h, "failed to create InferencePredictor");
    // keep the handle so the caller can read the error; predictor==NULL
    return h;
  }

  // cache the input signature for C-side introspection
  PyObject* sig = PyObject_GetAttrString(h->predictor, "signature");
  if (sig) {
    PyObject* names = PyDict_GetItemString(sig, "input_names");  // borrowed
    PyObject* inputs = PyDict_GetItemString(sig, "inputs");
    if (names && inputs) {
      Py_ssize_t n = PyList_Size(names);
      for (Py_ssize_t i = 0; i < n; i++) {
        h->in_names.push_back(PyUnicode_AsUTF8(PyList_GetItem(names, i)));
        PyObject* item = PyList_GetItem(inputs, i);
        PyObject* shp = PyDict_GetItemString(item, "shape");
        PyObject* dt = PyDict_GetItemString(item, "dtype");
        std::vector<int64_t> dims;
        for (Py_ssize_t d = 0; d < PyList_Size(shp); d++)
          dims.push_back(PyLong_AsLongLong(PyList_GetItem(shp, d)));
        h->in_shapes.push_back(dims);
        h->in_dtypes.push_back(dtype_code(PyUnicode_AsUTF8(dt)));
      }
    }
    Py_DECREF(sig);
  }
  PyErr_Clear();
  return h;
}

void* ptpu_clone(void* hp) {
  // ≈ AnalysisPredictor::Clone: a per-thread handle sharing the loaded
  // predictor, owning only its output slots. InferencePredictor.run keeps
  // no state between calls and serializes its program's launches under a
  // lock (the copies of the outputs to the host overlap).
  Handle* src = (Handle*)hp;
  if (!src || !src->predictor) return nullptr;  // closed/NULL handle
  Gil gil;
  Handle* h = new Handle();
  Py_INCREF(src->predictor);
  h->predictor = src->predictor;
  Py_INCREF(src->np);
  h->np = src->np;
  Py_INCREF(src->torch);
  h->torch = src->torch;
  h->in_names = src->in_names;
  h->in_shapes = src->in_shapes;
  h->in_dtypes = src->in_dtypes;
  return h;
}

const char* ptpu_last_error(void* hp) {
  return ((Handle*)hp)->error.c_str();
}

int ptpu_ok(void* hp) { return ((Handle*)hp)->predictor != nullptr; }

int ptpu_num_inputs(void* hp) {
  return (int)((Handle*)hp)->in_names.size();
}

const char* ptpu_input_name(void* hp, int i) {
  return ((Handle*)hp)->in_names[i].c_str();
}

int ptpu_input_rank(void* hp, int i) {
  return (int)((Handle*)hp)->in_shapes[i].size();
}

const int64_t* ptpu_input_shape(void* hp, int i) {
  return ((Handle*)hp)->in_shapes[i].data();
}

int ptpu_input_dtype(void* hp, int i) {
  return ((Handle*)hp)->in_dtypes[i];
}

}  // extern "C"

namespace {

// the caller's buffer as an ndarray of its shape, read in place; a
// bfloat16 buffer as a torch.bfloat16 tensor over a copy of its bits
PyObject* wrap(Handle* h, const PtpuTensor& t) {
  int64_t elems = 1;
  for (int d = 0; d < t.rank; d++) elems *= t.shape[d];
  bool bf16 = t.dtype == kBfloat16;
  PyObject* mv = PyMemoryView_FromMemory(
      (char*)t.data, elems * kItemSize[t.dtype], PyBUF_READ);
  PyObject* flat = PyObject_CallMethod(h->np, "frombuffer", "Os", mv,
                                       bf16 ? "uint16" : kDtypeNames[t.dtype]);
  Py_DECREF(mv);
  if (!flat) return nullptr;
  PyObject* shape = PyTuple_New(t.rank);
  for (int d = 0; d < t.rank; d++)
    PyTuple_SET_ITEM(shape, d, PyLong_FromLongLong(t.shape[d]));
  PyObject* arr = PyObject_CallMethod(flat, "reshape", "O", shape);
  Py_DECREF(shape);
  Py_DECREF(flat);
  if (!arr || !bf16) return arr;
  PyObject* bits = PyObject_CallMethod(arr, "copy", nullptr);
  Py_DECREF(arr);
  if (!bits) return nullptr;
  PyObject* u16 = PyObject_CallMethod(h->torch, "from_numpy", "O", bits);
  Py_DECREF(bits);
  if (!u16) return nullptr;
  PyObject* bf16_dtype = PyObject_GetAttrString(h->torch, "bfloat16");
  PyObject* out =
      bf16_dtype ? PyObject_CallMethod(u16, "view", "O", bf16_dtype) : nullptr;
  Py_XDECREF(bf16_dtype);
  Py_DECREF(u16);
  return out;
}

}  // namespace

extern "C" {

int ptpu_run(void* hp, const PtpuTensor* tensors, int n) {
  Handle* h = (Handle*)hp;
  if (!h->predictor) {
    h->error = "predictor not initialized";
    return -1;
  }
  Gil gil;
  clear_outputs(h);
  h->error.clear();

  PyObject* feed = PyList_New(n);
  for (int i = 0; i < n; i++) {
    if (tensors[i].dtype < 0 || tensors[i].dtype >= kNumDtypes) {
      Py_DECREF(feed);
      h->error = "bad input dtype code";
      return -1;
    }
    PyObject* arr = wrap(h, tensors[i]);
    if (!arr) {
      Py_DECREF(feed);
      set_py_error(h, "failed to wrap input buffer");
      return -1;
    }
    PyList_SET_ITEM(feed, i, arr);  // steals
  }

  PyObject* outs = PyObject_CallMethod(h->predictor, "run", "O", feed);
  Py_DECREF(feed);
  if (!outs) {
    set_py_error(h, "predictor.run failed");
    return -1;
  }

  Py_ssize_t n_out = PySequence_Size(outs);
  for (Py_ssize_t i = 0; i < n_out; i++) {
    PyObject* o = PySequence_GetItem(outs, i);  // new ref
    PyObject* contig =
        PyObject_CallMethod(h->np, "ascontiguousarray", "O", o);
    Py_DECREF(o);
    if (!contig) {
      Py_DECREF(outs);
      set_py_error(h, "output not convertible");
      return -1;
    }
    Output out;
    out.array = contig;
    PyObject* shp = PyObject_GetAttrString(contig, "shape");
    for (Py_ssize_t d = 0; d < PyTuple_Size(shp); d++)
      out.shape.push_back(PyLong_AsLongLong(PyTuple_GetItem(shp, d)));
    Py_DECREF(shp);
    PyObject* dt = PyObject_GetAttrString(contig, "dtype");
    PyObject* dname = PyObject_GetAttrString(dt, "name");
    out.dtype = dtype_code(PyUnicode_AsUTF8(dname));
    Py_DECREF(dname);
    Py_DECREF(dt);
    PyObject* iface = PyObject_GetAttrString(contig, "ctypes");
    PyObject* ptr = PyObject_GetAttrString(iface, "data");
    out.data = (void*)PyLong_AsUnsignedLongLong(ptr);
    Py_DECREF(ptr);
    Py_DECREF(iface);
    PyObject* nb = PyObject_GetAttrString(contig, "nbytes");
    out.nbytes = PyLong_AsLongLong(nb);
    Py_DECREF(nb);
    h->outputs.push_back(out);
  }
  Py_DECREF(outs);
  return 0;
}

int ptpu_num_outputs(void* hp) {
  return (int)((Handle*)hp)->outputs.size();
}

int ptpu_output_rank(void* hp, int i) {
  return (int)((Handle*)hp)->outputs[i].shape.size();
}

const int64_t* ptpu_output_shape(void* hp, int i) {
  return ((Handle*)hp)->outputs[i].shape.data();
}

int ptpu_output_dtype(void* hp, int i) {
  return ((Handle*)hp)->outputs[i].dtype;
}

const void* ptpu_output_data(void* hp, int i) {
  return ((Handle*)hp)->outputs[i].data;
}

int64_t ptpu_output_nbytes(void* hp, int i) {
  return ((Handle*)hp)->outputs[i].nbytes;
}

void ptpu_destroy(void* hp) {
  Handle* h = (Handle*)hp;
  if (Py_IsInitialized()) {
    Gil gil;
    clear_outputs(h);
    Py_XDECREF(h->predictor);
    Py_XDECREF(h->np);
    Py_XDECREF(h->torch);
  }
  delete h;
}

}  // extern "C"
