// Native ingest kernels (C++, CPython C API — no pybind11 in this image).
//
// The reference's ingest hot path is JVM whole-stage codegen writing
// off-heap buffers (ColumnInsertExec + ColumnEncoder, encoders/...).
// Ours is this module: a single fused pass over a numpy object array of
// strings that interns against the table's shared dictionary, emits int32
// codes and the null mask in one sweep — the dominant CPU cost of
// columnar ingest once numeric columns are memcpy'd.
//
// Exposed functions:
//   encode_strings(values: np.ndarray[object], lookup: dict, store: list)
//       -> (codes: np.ndarray[int32], nulls: np.ndarray[bool] | None)
//
// Built by snappydata_tpu_torch/native/__init__.py with the system g++ at
// first use; the vectorized pandas encoder (storage/strings.py) is its
// plain version and keeps ingest working without a compiler.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

extern "C" {

static PyObject *encode_strings(PyObject *self, PyObject *args) {
    PyObject *values_obj, *lookup, *store;
    if (!PyArg_ParseTuple(args, "OO!O!", &values_obj, &PyDict_Type, &lookup,
                          &PyList_Type, &store)) {
        return nullptr;
    }
    PyArrayObject *values = (PyArrayObject *)PyArray_FROM_OTF(
        values_obj, NPY_OBJECT, NPY_ARRAY_IN_ARRAY);
    if (values == nullptr) {
        return nullptr;
    }
    const npy_intp n = PyArray_SIZE(values);

    npy_intp dims[1] = {n};
    PyArrayObject *codes =
        (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_INT32);
    PyArrayObject *nulls =
        (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_BOOL);
    if (codes == nullptr || nulls == nullptr) {
        Py_XDECREF(codes);
        Py_XDECREF(nulls);
        Py_DECREF(values);
        return nullptr;
    }
    int32_t *codes_data = (int32_t *)PyArray_DATA(codes);
    npy_bool *nulls_data = (npy_bool *)PyArray_DATA(nulls);
    PyObject **items = (PyObject **)PyArray_DATA(values);

    bool any_null = false;
    PyObject *prev = nullptr;  // run-of-equal-pointers fast path
    int32_t prev_code = 0;

    for (npy_intp i = 0; i < n; i++) {
        PyObject *v = items[i];
        if (v == Py_None) {
            codes_data[i] = 0;
            nulls_data[i] = NPY_TRUE;
            any_null = true;
            prev = nullptr;
            continue;
        }
        nulls_data[i] = NPY_FALSE;
        if (v == prev) {  // identical object repeated (common for
                          // low-cardinality columns)
            codes_data[i] = prev_code;
            continue;
        }
        PyObject *idx = PyDict_GetItemWithError(lookup, v);  // borrowed
        int32_t code;
        if (idx != nullptr) {
            code = (int32_t)PyLong_AsLong(idx);
        } else {
            if (PyErr_Occurred()) {
                goto fail;
            }
            code = (int32_t)PyList_GET_SIZE(store);
            PyObject *code_obj = PyLong_FromLong(code);
            if (code_obj == nullptr ||
                PyDict_SetItem(lookup, v, code_obj) < 0 ||
                PyList_Append(store, v) < 0) {
                Py_XDECREF(code_obj);
                goto fail;
            }
            Py_DECREF(code_obj);
        }
        codes_data[i] = code;
        prev = v;
        prev_code = code;
    }

    Py_DECREF(values);
    if (!any_null) {
        Py_DECREF(nulls);
        return Py_BuildValue("(NO)", codes, Py_None);
    }
    return Py_BuildValue("(NN)", codes, nulls);

fail:
    Py_DECREF(codes);
    Py_DECREF(nulls);
    Py_DECREF(values);
    return nullptr;
}

static PyMethodDef Methods[] = {
    {"encode_strings", encode_strings, METH_VARARGS,
     "Fused intern + dictionary-encode + null-mask pass over an object "
     "array of strings."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastingest",
    "Native ingest kernels for snappydata_tpu_torch", -1, Methods,
};

PyMODINIT_FUNC PyInit__fastingest(void) {
    import_array();
    return PyModule_Create(&moduledef);
}

}  // extern "C"
