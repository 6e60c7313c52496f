// caffe_ MEX entry point for the deepcut_tpu_torch MATLAB binding.
//
// The reference binds MATLAB by linking libcaffe and hand-writing one C++
// handler per command (the command table of the reference's
// matlab/+caffe/private/caffe_.cpp). Here the framework lives in Python, so
// this file is a single GENERIC marshaller: it embeds CPython, converts each
// mxArray argument to a plain Python value, forwards every command to
// deepcut_tpu_torch.matlab_gateway.dispatch(cmd, args), and converts the
// typed result items back to mxArrays. All command semantics live in the
// Python gateway, shared with pycaffe — this layer only moves memory. It is
// the JAX package's marshaller (matlab/+caffe/private/caffe_.cpp) with the
// port's gateway module in place of deepcut_tpu.matlab_gateway.
//
// Layout contract (the reference's): MATLAB arrays are column-major with
// width fastest, Caffe/numpy row-major with width fastest, so a MATLAB
// (W,H,C,N) single array and a C-order (N,C,H,W) float32 array are the same
// bytes. The marshaller therefore ships raw bytes plus MATLAB-order dims and
// never permutes elements.
//
// Build inside MATLAB:    python -m deepcut_tpu_torch.matlab.build --matlab
//                         (assembles the +caffe package and prints the mex
//                         line; see build.py)
// Build for the test rig: python -m deepcut_tpu_torch.matlab.build
//                         (links the repo's matlab/mex_stub/mex_stub.cpp)

#include <Python.h>

#include <cstring>
#include <string>
#include <vector>

#include "mex.h"

#define MEX_ARGS int nlhs, mxArray **plhs, int nrhs, const mxArray **prhs

namespace {

// ----------------------------------------------------------------- errors

void fail(const std::string& msg) {
  static std::string buf;  // outlives the longjmp mexErrMsgTxt performs
  buf = msg;
  mexErrMsgTxt(buf.c_str());
}

std::string python_error_text() {
  PyObject *type = NULL, *value = NULL, *trace = NULL;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  std::string msg = "Python error in deepcut_tpu_torch.matlab_gateway";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      msg = PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return msg;
}

// ------------------------------------------------------ interpreter setup

PyObject* gateway_dispatch() {  // borrowed-ish: cached for process lifetime
  static PyObject* dispatch = NULL;
  if (dispatch) return dispatch;
  if (!Py_IsInitialized()) Py_InitializeEx(0);
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("deepcut_tpu_torch.matlab_gateway");
  if (mod) {
    dispatch = PyObject_GetAttrString(mod, "dispatch");
    Py_DECREF(mod);
  }
  std::string err;
  if (!dispatch) err = python_error_text();
  PyGILState_Release(g);
  if (!dispatch)
    fail("caffe_: cannot import deepcut_tpu_torch.matlab_gateway (is the package "
         "on PYTHONPATH?): " + err);
  return dispatch;
}

// --------------------------------------------------- mxArray -> PyObject

PyObject* mx_to_py(const mxArray* pa) {
  if (mxIsChar(pa)) {
    char* s = mxArrayToString(pa);
    PyObject* out = PyUnicode_FromString(s);
    mxFree(s);
    return out;
  }
  if (mxIsDouble(pa)) {
    const size_t n = mxGetNumberOfElements(pa);
    const double* v = mxGetPr(pa);
    if (n == 1) return PyFloat_FromDouble(v[0]);
    PyObject* lst = PyList_New(n);
    for (size_t i = 0; i < n; ++i)
      PyList_SET_ITEM(lst, i, PyFloat_FromDouble(v[i]));
    return lst;
  }
  if (mxIsSingle(pa)) {
    // {"dims": MATLAB dims, "data": raw column-major f32 bytes}
    const mwSize nd = mxGetNumberOfDimensions(pa);
    const mwSize* dims = mxGetDimensions(pa);
    PyObject* pdims = PyTuple_New(nd);
    size_t count = 1;
    for (mwSize i = 0; i < nd; ++i) {
      PyTuple_SET_ITEM(pdims, i, PyLong_FromSize_t(dims[i]));
      count *= dims[i];
    }
    PyObject* bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(mxGetData(pa)), count * sizeof(float));
    PyObject* d = Py_BuildValue("{s:N,s:N}", "dims", pdims, "data", bytes);
    return d;
  }
  if (mxIsStruct(pa)) {
    // object handle: {ptr, init_key}
    mxArray* ptr = mxGetField(pa, 0, "ptr");
    mxArray* key = mxGetField(pa, 0, "init_key");
    if (!ptr || !key) return NULL;
    unsigned long long pv = 0;
    if (mxIsUint64(ptr))
      pv = *static_cast<unsigned long long*>(mxGetData(ptr));
    else
      pv = static_cast<unsigned long long>(mxGetScalar(ptr));
    return Py_BuildValue("{s:K,s:d}", "ptr", pv, "init_key",
                         mxGetScalar(key));
  }
  return NULL;
}

// --------------------------------------------------- PyObject -> mxArray

std::string dict_str(PyObject* d, const char* k) {
  PyObject* v = PyDict_GetItemString(d, k);  // borrowed
  return v && PyUnicode_Check(v) ? PyUnicode_AsUTF8(v) : "";
}

mxArray* handle_to_mx_into(PyObject* h, mxArray* vec, mwIndex i) {
  mxArray* ptr = mxCreateNumericMatrix(1, 1, mxUINT64_CLASS, mxREAL);
  *static_cast<unsigned long long*>(mxGetData(ptr)) =
      PyLong_AsUnsignedLongLong(PyDict_GetItemString(h, "ptr"));
  mxSetField(vec, i, "ptr", ptr);
  mxSetField(vec, i, "init_key",
             mxCreateDoubleScalar(
                 PyFloat_AsDouble(PyDict_GetItemString(h, "init_key"))));
  return vec;
}

mxArray* item_to_mx(PyObject* item);  // fwd (structs recurse)

mxArray* handles_to_mx(PyObject* lst) {
  static const char* fields[] = {"ptr", "init_key"};
  const mwSize n = PyList_Size(lst);
  mxArray* vec = mxCreateStructMatrix(n, 1, 2, fields);
  for (mwSize i = 0; i < n; ++i)
    handle_to_mx_into(PyList_GetItem(lst, i), vec, i);
  return vec;
}

mxArray* item_to_mx(PyObject* item) {
  if (PyDict_GetItemString(item, "ptr")) {
    // bare object handle (get_net / get_solver results): 1x1 struct
    static const char* hf[] = {"ptr", "init_key"};
    return handle_to_mx_into(item, mxCreateStructMatrix(1, 1, 2, hf), 0);
  }
  const std::string t = dict_str(item, "t");
  PyObject* v = PyDict_GetItemString(item, "v");  // borrowed, may be NULL
  if (t == "str") return mxCreateString(PyUnicode_AsUTF8(v));
  if (t == "double") return mxCreateDoubleScalar(PyFloat_AsDouble(v));
  if (t == "dvec") {
    const mwSize rows = static_cast<mwSize>(
        PyLong_AsLong(PyDict_GetItemString(item, "rows")));
    const mwSize cols = static_cast<mwSize>(
        PyLong_AsLong(PyDict_GetItemString(item, "cols")));
    mxArray* m = mxCreateDoubleMatrix(rows, cols, mxREAL);
    double* p = mxGetPr(m);
    for (Py_ssize_t i = 0; i < PyList_Size(v); ++i)
      p[i] = PyFloat_AsDouble(PyList_GetItem(v, i));
    return m;
  }
  if (t == "handles") return handles_to_mx(v);
  if (t == "strcell") {
    const mwSize n = PyList_Size(v);
    mxArray* cell = mxCreateCellMatrix(n, 1);
    for (mwSize i = 0; i < n; ++i)
      mxSetCell(cell, i,
                mxCreateString(PyUnicode_AsUTF8(PyList_GetItem(v, i))));
    return cell;
  }
  if (t == "single") {
    PyObject* pdims = PyDict_GetItemString(item, "dims");
    const mwSize nd = PyList_Size(pdims);
    std::vector<mwSize> dims(nd);
    for (mwSize i = 0; i < nd; ++i)
      dims[i] = static_cast<mwSize>(
          PyLong_AsLong(PyList_GetItem(pdims, i)));
    mxArray* arr =
        mxCreateNumericArray(nd, dims.data(), mxSINGLE_CLASS, mxREAL);
    PyObject* data = PyDict_GetItemString(item, "data");
    std::memcpy(mxGetData(arr), PyBytes_AsString(data),
                PyBytes_Size(data));
    return arr;
  }
  if (t == "struct") {
    PyObject* fields = PyDict_GetItemString(item, "fields");
    const Py_ssize_t nf = PyList_Size(fields);
    std::vector<std::string> names(nf);
    std::vector<const char*> cnames(nf);
    for (Py_ssize_t i = 0; i < nf; ++i) {
      names[i] = PyUnicode_AsUTF8(
          PyTuple_GetItem(PyList_GetItem(fields, i), 0));
      cnames[i] = names[i].c_str();
    }
    mxArray* st = mxCreateStructMatrix(1, 1, nf, cnames.data());
    for (Py_ssize_t i = 0; i < nf; ++i)
      mxSetField(st, 0, cnames[i],
                 item_to_mx(PyTuple_GetItem(PyList_GetItem(fields, i), 1)));
    return st;
  }
  return NULL;
}

}  // namespace

// ------------------------------------------------------------ entry point

void mexFunction(MEX_ARGS) {
  mexLock();  // keep the embedded interpreter alive across calls
  if (nrhs < 1 || !mxIsChar(prhs[0]))
    fail("Usage: caffe_(api_command, arg1, arg2, ...)");
  PyObject* dispatch = gateway_dispatch();

  PyGILState_STATE g = PyGILState_Ensure();
  char* cmd_c = mxArrayToString(prhs[0]);
  const std::string cmd = cmd_c;
  mxFree(cmd_c);

  PyObject* args = PyList_New(nrhs - 1);
  bool bad_arg = false;
  for (int i = 1; i < nrhs; ++i) {
    PyObject* p = mx_to_py(prhs[i]);
    if (!p) {
      p = Py_None;
      Py_INCREF(Py_None);
      bad_arg = true;
    }
    PyList_SET_ITEM(args, i - 1, p);
  }
  if (bad_arg) {
    Py_DECREF(args);
    PyGILState_Release(g);
    fail("caffe_('" + cmd + "'): unsupported argument type");
  }

  PyObject* results =
      PyObject_CallFunction(dispatch, "sN", cmd.c_str(), args);
  if (!results) {
    const std::string err = python_error_text();
    PyGILState_Release(g);
    fail(err);
  }

  int out = 0;
  const int max_out = nlhs > 0 ? nlhs : 1;
  std::string err;
  for (Py_ssize_t i = 0; i < PyList_Size(results) && err.empty(); ++i) {
    PyObject* item = PyList_GetItem(results, i);  // borrowed
    if (dict_str(item, "t") == "print") {
      mexPrintf("%s", dict_str(item, "v").c_str());
      continue;
    }
    if (out >= max_out) continue;  // caller asked for fewer outputs
    mxArray* mx = item_to_mx(item);
    if (!mx)
      err = "caffe_('" + cmd + "'): unsupported result type";
    else
      plhs[out++] = mx;
  }
  Py_DECREF(results);
  PyGILState_Release(g);
  if (!err.empty()) fail(err);
}
