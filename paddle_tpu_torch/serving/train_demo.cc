// C++ training demo of the PyTorch port — a native application that OWNS
// the training loop (port of paddle_tpu/serving/train_demo.cc).
//
// Capability-equivalent of the reference's C++ trainer demo
// (paddle/fluid/train/demo/demo_trainer.cc and
// train/test_train_recognize_digits.cc: load a program, run the train op
// loop from C++, watch the loss fall). PyTorch is the executor, reached
// through an embedded CPython that builds a paddle_tpu_torch Trainer once
// on the device; the C++ side then drives every step — it synthesizes
// each minibatch into its own buffers (deterministic LCG), hands them to
// the step (numpy.frombuffer over a memoryview, then to the device), reads
// the loss back as a C double, decides when to stop, and asks for a
// checkpoint at the end.
//
// Usage: ptpu_train_demo <sys_path> <ckpt_dir> [device]
// device: "cuda", "cpu", ...; absent or "" means the card (no card: the
// Trainer's model raises, and the demo fails).
// Exit 0 iff the loss decreased and the checkpoint was written.
//
// Build (paddle_tpu_torch.serving.build_train_demo):
//   g++ -O2 -std=c++17 train_demo.cc -I<python include> \
//       -L<libdir> -lpython3.12 -Wl,-rpath,<libdir> -o ptpu_train_demo

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kBatch = 64;
constexpr int kDim = 16;
constexpr int kClasses = 4;
constexpr int kSteps = 40;

// Deterministic synthetic classification data: label = argmax of 4 fixed
// random projections. C++ owns generation (the DataFeed role).
struct Lcg {
  uint64_t s;
  explicit Lcg(uint64_t seed) : s(seed) {}
  double next() {  // uniform [-1, 1)
    s = s * 6364136223846793005ULL + 1442695040888963407ULL;
    return static_cast<double>(static_cast<int64_t>(s >> 11)) /
           static_cast<double>(1ULL << 52) - 1.0;
  }
};

// `_device` (None = the card) is set in the namespace before this runs
const char* kBootstrap = R"PY(
import numpy as np
import torch
from paddle_tpu_torch.core.executor import Trainer, supervised_loss
from paddle_tpu_torch.io.checkpoint import save_checkpoint
from paddle_tpu_torch.metrics import accuracy
from paddle_tpu_torch.models import MLP
from paddle_tpu_torch.ops import functional as F
from paddle_tpu_torch.optim.optimizer import Adam

_model = MLP(hidden=(32,), num_classes=%d, in_shape=(%d, 1, 1),
             device=_device)
_loss = supervised_loss(
    lambda lg, y: F.softmax_with_cross_entropy(lg, y),
    metrics={"acc": accuracy})
_trainer = Trainer(_model, Adam(_model.parameters(), 5e-2), _loss)
_dev = _model.device

def step(x_mv, y_mv):
    x = np.frombuffer(x_mv, np.float32).reshape(%d, %d)
    y = np.frombuffer(y_mv, np.int32).astype(np.int64)
    fetches = _trainer.train_step((torch.from_numpy(x.copy()).to(_dev),
                                   torch.from_numpy(y).to(_dev)))
    return float(fetches["loss"])

def checkpoint(path):
    ts = _trainer.state()
    save_checkpoint(path, {"params": ts.params, "opt": ts.opt_state})
    return True
)PY";

bool fail(const char* what) {
  if (PyErr_Occurred()) PyErr_Print();
  std::fprintf(stderr, "train_demo: %s\n", what);
  return false;
}

bool run(const std::string& sys_path, const std::string& ckpt_dir,
         const std::string& device) {
  // module namespace with the bootstrap executed in it
  PyObject* mod = PyImport_AddModule("__main__");  // borrowed
  PyObject* g = PyModule_GetDict(mod);             // borrowed

  // sys.path entries (colon-separated); inserted at increasing indices so
  // the caller's order is preserved (first entry wins imports)
  PyObject* sys_path_list = PySys_GetObject("path");  // borrowed
  size_t start = 0;
  Py_ssize_t insert_at = 0;
  while (start <= sys_path.size()) {
    size_t end = sys_path.find(':', start);
    if (end == std::string::npos) end = sys_path.size();
    std::string piece = sys_path.substr(start, end - start);
    if (!piece.empty()) {
      PyObject* p = PyUnicode_FromString(piece.c_str());
      PyList_Insert(sys_path_list, insert_at++, p);
      Py_DECREF(p);
    }
    start = end + 1;
  }

  PyObject* dev = device.empty() ? (Py_INCREF(Py_None), Py_None)
                                 : PyUnicode_FromString(device.c_str());
  PyDict_SetItemString(g, "_device", dev);
  Py_DECREF(dev);

  char bootstrap[4096];
  std::snprintf(bootstrap, sizeof(bootstrap), kBootstrap, kClasses, kDim,
                kBatch, kDim);
  PyObject* r = PyRun_String(bootstrap, Py_file_input, g, g);
  if (!r) return fail("bootstrap failed");
  Py_DECREF(r);

  PyObject* step = PyDict_GetItemString(g, "step");        // borrowed
  PyObject* checkpoint = PyDict_GetItemString(g, "checkpoint");
  if (!step || !checkpoint) return fail("bootstrap symbols missing");

  // fixed projection matrix defining the labels
  Lcg wrng(7);
  float w[kDim][kClasses];
  for (int i = 0; i < kDim; i++)
    for (int c = 0; c < kClasses; c++)
      w[i][c] = static_cast<float>(wrng.next());

  std::vector<float> x(kBatch * kDim);
  std::vector<int32_t> y(kBatch);
  double first = -1.0, last = -1.0;

  for (int s = 0; s < kSteps; s++) {
    Lcg rng(1000 + s);
    for (int b = 0; b < kBatch; b++) {
      float logits[kClasses] = {0};
      for (int i = 0; i < kDim; i++) {
        float v = static_cast<float>(rng.next());
        x[b * kDim + i] = v;
        for (int c = 0; c < kClasses; c++) logits[c] += v * w[i][c];
      }
      int best = 0;
      for (int c = 1; c < kClasses; c++)
        if (logits[c] > logits[best]) best = c;
      y[b] = best;
    }
    // views over the C buffers
    PyObject* xv = PyMemoryView_FromMemory(
        reinterpret_cast<char*>(x.data()), x.size() * sizeof(float),
        PyBUF_READ);
    PyObject* yv = PyMemoryView_FromMemory(
        reinterpret_cast<char*>(y.data()), y.size() * sizeof(int32_t),
        PyBUF_READ);
    PyObject* res = PyObject_CallFunctionObjArgs(step, xv, yv, nullptr);
    Py_DECREF(xv);
    Py_DECREF(yv);
    if (!res) return fail("step failed");
    last = PyFloat_AsDouble(res);
    Py_DECREF(res);
    if (s == 0) first = last;
    if (s % 10 == 0) std::printf("step %d loss %.4f\n", s, last);
  }
  std::printf("first %.4f final %.4f\n", first, last);

  PyObject* ck = PyObject_CallFunction(checkpoint, "s", ckpt_dir.c_str());
  if (!ck) return fail("checkpoint failed");
  Py_DECREF(ck);

  if (!(last < first * 0.8)) return fail("loss did not decrease");
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <sys_path> <ckpt_dir> [device]\n",
                 argv[0]);
    return 2;
  }
  Py_Initialize();
  bool ok = run(argv[1], argv[2], argc > 3 ? argv[3] : "");
  Py_Finalize();
  std::printf(ok ? "TRAIN DEMO OK\n" : "TRAIN DEMO FAILED\n");
  return ok ? 0 : 1;
}
