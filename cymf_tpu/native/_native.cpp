// Native host-side components for cymf-tpu.
//
// The reference implements its co-occurrence accumulation in Cython over a
// C++ unordered_map (/root/reference/cymf/glove.pyx:183-241 — behavior
// reimplemented here from scratch, not copied).  This extension provides the
// same hot loop as a plain CPython C API module (no pybind11 dependency):
//
//   cooccurrence(flat_ids: bytes/buffer of int64, line_lens: buffer of
//                int64, vocab_size: int, window_size: int)
//     -> (keys_bytes, vals_bytes)
//
// Keys are center + context * vocab_size (int64), values are the summed
// 1/distance weights (float64), serialized as raw little-endian buffers the
// Python wrapper views with numpy.frombuffer.
//
// Build: `make native` (see Makefile) or `python setup.py build_ext
// --inplace`.  A pure-python fallback exists in cymf_tpu/dataset/text.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct BufferGuard {
  Py_buffer view{};
  bool ok = false;
  ~BufferGuard() {
    if (ok) PyBuffer_Release(&view);
  }
};

static PyObject* cooccurrence(PyObject* /*self*/, PyObject* args) {
  PyObject* flat_obj = nullptr;
  PyObject* lens_obj = nullptr;
  long long vocab_size = 0;
  long long window_size = 0;
  if (!PyArg_ParseTuple(args, "OOLL", &flat_obj, &lens_obj, &vocab_size,
                        &window_size)) {
    return nullptr;
  }

  BufferGuard flat_buf, lens_buf;
  if (PyObject_GetBuffer(flat_obj, &flat_buf.view, PyBUF_CONTIG_RO) != 0)
    return nullptr;
  flat_buf.ok = true;
  if (PyObject_GetBuffer(lens_obj, &lens_buf.view, PyBUF_CONTIG_RO) != 0)
    return nullptr;
  lens_buf.ok = true;

  const int64_t* flat = static_cast<const int64_t*>(flat_buf.view.buf);
  const int64_t* lens = static_cast<const int64_t*>(lens_buf.view.buf);
  const Py_ssize_t num_lines =
      lens_buf.view.len / static_cast<Py_ssize_t>(sizeof(int64_t));

  std::unordered_map<int64_t, double> acc;
  acc.reserve(1 << 20);

  Py_BEGIN_ALLOW_THREADS;
  int64_t offset = 0;
  for (Py_ssize_t line = 0; line < num_lines; ++line) {
    const int64_t n = lens[line];
    const int64_t* ids = flat + offset;
    for (int64_t j = 0; j < n; ++j) {
      const int64_t lo = j - window_size > 0 ? j - window_size : 0;
      for (int64_t k = lo; k < j; ++k) {
        // left window only, 1/distance weighting
        acc[ids[j] + ids[k] * vocab_size] += 1.0 / static_cast<double>(j - k);
      }
    }
    offset += n;
  }
  Py_END_ALLOW_THREADS;

  const Py_ssize_t nnz = static_cast<Py_ssize_t>(acc.size());
  PyObject* keys_bytes =
      PyBytes_FromStringAndSize(nullptr, nnz * sizeof(int64_t));
  PyObject* vals_bytes =
      PyBytes_FromStringAndSize(nullptr, nnz * sizeof(double));
  if (!keys_bytes || !vals_bytes) {
    Py_XDECREF(keys_bytes);
    Py_XDECREF(vals_bytes);
    return nullptr;
  }
  int64_t* keys = reinterpret_cast<int64_t*>(PyBytes_AS_STRING(keys_bytes));
  double* vals = reinterpret_cast<double*>(PyBytes_AS_STRING(vals_bytes));
  Py_ssize_t idx = 0;
  for (const auto& kv : acc) {
    keys[idx] = kv.first;
    vals[idx] = kv.second;
    ++idx;
  }
  return Py_BuildValue("(NN)", keys_bytes, vals_bytes);
}

static PyMethodDef kMethods[] = {
    {"cooccurrence", cooccurrence, METH_VARARGS,
     "Accumulate left-window 1/distance co-occurrence counts."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_native",
    "Native host-side kernels for cymf-tpu.", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&kModule); }
