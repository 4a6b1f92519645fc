// Native dataset-index builders (a copy of megatron_tpu/data/_helpers.cpp,
// the port's own).
//
// The reference's helpers.cpp entry points (build_sample_idx,
// build_blending_indices, build_mapping, build_blocks_mapping) with the
// same contracts, written against the CPython + NumPy C APIs (no
// pybind11). They run on the host CPU during dataset construction: the
// index walks are O(total_tokens) loop-shaped work that numpy cannot
// vectorize. The Python versions with identical semantics live in
// megatron_tpu_torch/data/helpers.py.
//
// Build: megatron_tpu_torch/data/helpers.py compiles this with g++ at
// first use into megatron_tpu_torch/build/.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cstdint>
#include <random>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// build_sample_idx(sizes: i32[], doc_idx: i32[], seq_length: int,
//                  num_epochs: int, tokens_per_epoch: long) -> i32[n+1, 2]
//
// Walks documents in doc_idx order, marking where each fixed-length training
// sample starts as a (doc_idx position, token offset) pair. Each sample
// advances seq_length tokens; readers take seq_length+1 tokens so
// consecutive samples share one boundary token (input/label overlap).
// ---------------------------------------------------------------------------
PyObject* build_sample_idx(PyObject*, PyObject* args) {
  PyArrayObject *sizes_obj, *doc_idx_obj;
  int seq_length, num_epochs;
  long long tokens_per_epoch;
  if (!PyArg_ParseTuple(args, "O!O!iiL", &PyArray_Type, &sizes_obj,
                        &PyArray_Type, &doc_idx_obj, &seq_length, &num_epochs,
                        &tokens_per_epoch)) {
    return nullptr;
  }
  if (PyArray_TYPE(sizes_obj) != NPY_INT32 ||
      PyArray_TYPE(doc_idx_obj) != NPY_INT32) {
    PyErr_SetString(PyExc_TypeError, "sizes and doc_idx must be int32");
    return nullptr;
  }
  const int32_t* sizes = static_cast<int32_t*>(PyArray_DATA(sizes_obj));
  const int32_t* doc_idx = static_cast<int32_t*>(PyArray_DATA(doc_idx_obj));
  const npy_intp n_docs = PyArray_SIZE(doc_idx_obj);

  const int64_t total_tokens =
      static_cast<int64_t>(num_epochs) * tokens_per_epoch;
  const int64_t num_samples = (total_tokens - 1) / seq_length;

  npy_intp dims[2] = {static_cast<npy_intp>(num_samples + 1), 2};
  PyObject* out = PyArray_SimpleNew(2, dims, NPY_INT32);
  if (!out) return nullptr;
  int32_t* sample_idx =
      static_cast<int32_t*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(out)));

  int64_t doc_pos = 0;   // index into doc_idx
  int32_t offset = 0;    // token offset inside current doc
  sample_idx[0] = 0;
  sample_idx[1] = 0;
  for (int64_t i = 1; i <= num_samples; ++i) {
    int32_t remaining = seq_length;
    while (remaining > 0) {
      if (doc_pos >= n_docs) {  // defensive; cannot happen with valid inputs
        PyErr_SetString(PyExc_ValueError, "ran out of documents");
        Py_DECREF(out);
        return nullptr;
      }
      const int32_t doc_len = sizes[doc_idx[doc_pos]] - offset;
      if (doc_len > remaining) {
        offset += remaining;
        remaining = 0;
      } else {
        remaining -= doc_len;
        ++doc_pos;
        offset = 0;
      }
    }
    sample_idx[2 * i] = static_cast<int32_t>(doc_pos);
    sample_idx[2 * i + 1] = offset;
  }
  return out;
}

// ---------------------------------------------------------------------------
// build_blending_indices(dataset_index: u8[size], dataset_sample_index:
//   i64[size], weights: f64[n], num_datasets: int, size: long,
//   verbose: bool) -> None  (fills the two output arrays)
//
// Greedy proportional-fill: sample i goes to the dataset whose achieved
// count lags its target weight*(i+1) the most.
// ---------------------------------------------------------------------------
PyObject* build_blending_indices(PyObject*, PyObject* args) {
  PyArrayObject *didx_obj, *dsamp_obj, *weights_obj;
  int num_datasets, verbose;
  long long size;
  if (!PyArg_ParseTuple(args, "O!O!O!iLi", &PyArray_Type, &didx_obj,
                        &PyArray_Type, &dsamp_obj, &PyArray_Type, &weights_obj,
                        &num_datasets, &size, &verbose)) {
    return nullptr;
  }
  uint8_t* dataset_index = static_cast<uint8_t*>(PyArray_DATA(didx_obj));
  int64_t* dataset_sample_index = static_cast<int64_t*>(PyArray_DATA(dsamp_obj));
  const double* weights = static_cast<double*>(PyArray_DATA(weights_obj));

  std::vector<int64_t> current(num_datasets, 0);
  for (int64_t i = 0; i < size; ++i) {
    int best = 0;
    double best_err = weights[0] * (i + 1) - static_cast<double>(current[0]);
    for (int d = 1; d < num_datasets; ++d) {
      const double err = weights[d] * (i + 1) - static_cast<double>(current[d]);
      if (err > best_err) {
        best_err = err;
        best = d;
      }
    }
    dataset_index[i] = static_cast<uint8_t>(best);
    dataset_sample_index[i] = current[best];
    ++current[best];
  }
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------------
// build_mapping(docs: i64[], sizes: i32[], num_epochs, max_num_samples,
//   max_seq_length, short_seq_prob, seed, verbose, min_num_sent)
//   -> i64[n, 3]  (start_sentence, end_sentence, target_seq_length)
//
// Sentence-pair sample map for masked-LM training: greedily packs
// consecutive sentences of a document up to a (sometimes shortened) target
// length, requiring at least min_num_sent sentences per sample.
// ---------------------------------------------------------------------------
PyObject* build_mapping(PyObject*, PyObject* args) {
  PyArrayObject *docs_obj, *sizes_obj;
  int num_epochs, max_seq_length, seed, verbose, min_num_sent;
  long long max_num_samples;
  double short_seq_prob;
  if (!PyArg_ParseTuple(args, "O!O!iLidiii", &PyArray_Type, &docs_obj,
                        &PyArray_Type, &sizes_obj, &num_epochs,
                        &max_num_samples, &max_seq_length, &short_seq_prob,
                        &seed, &verbose, &min_num_sent)) {
    return nullptr;
  }
  const int64_t* docs = static_cast<int64_t*>(PyArray_DATA(docs_obj));
  const int32_t* sizes = static_cast<int32_t*>(PyArray_DATA(sizes_obj));
  const npy_intp n_docs = PyArray_SIZE(docs_obj) - 1;

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::vector<int64_t> maps;
  maps.reserve(1024);

  int64_t n_samples = 0;
  for (int epoch = 0; epoch < num_epochs && n_samples < max_num_samples;
       ++epoch) {
    for (npy_intp d = 0; d < n_docs && n_samples < max_num_samples; ++d) {
      const int64_t sent_begin = docs[d];
      const int64_t sent_end = docs[d + 1];
      const int64_t n_sent = sent_end - sent_begin;
      if (n_sent < min_num_sent) continue;

      int target = max_seq_length;
      if (unif(rng) < short_seq_prob) {
        target = 2 + static_cast<int>(unif(rng) * (max_seq_length - 2));
      }
      int64_t start = sent_begin;
      int32_t acc = 0;
      int64_t num_in_sample = 0;
      for (int64_t s = sent_begin; s < sent_end; ++s) {
        acc += sizes[s];
        ++num_in_sample;
        const bool last = (s == sent_end - 1);
        if ((acc >= target && num_in_sample >= min_num_sent) ||
            (last && num_in_sample >= min_num_sent)) {
          maps.push_back(start);
          maps.push_back(s + 1);
          maps.push_back(target);
          ++n_samples;
          start = s + 1;
          acc = 0;
          num_in_sample = 0;
          if (n_samples >= max_num_samples) break;
          if (unif(rng) < short_seq_prob) {
            target = 2 + static_cast<int>(unif(rng) * (max_seq_length - 2));
          } else {
            target = max_seq_length;
          }
        }
      }
    }
  }

  npy_intp dims[2] = {static_cast<npy_intp>(maps.size() / 3), 3};
  PyObject* out = PyArray_SimpleNew(2, dims, NPY_INT64);
  if (!out) return nullptr;
  std::copy(maps.begin(), maps.end(),
            static_cast<int64_t*>(
                PyArray_DATA(reinterpret_cast<PyArrayObject*>(out))));
  return out;
}

// ---------------------------------------------------------------------------
// build_blocks_mapping(docs: i64[], sizes: i32[], titles: i32[], num_epochs,
//   max_num_samples, max_seq_length, seed, verbose, use_one_sent_blocks)
//   -> i64[n, 4]  (start_sentence, end_sentence, doc_index, block_index)
//
// ICT/REALM block map: contiguous sentence blocks up to max_seq_length
// (minus the title length), tagged with their document.
// ---------------------------------------------------------------------------
PyObject* build_blocks_mapping(PyObject*, PyObject* args) {
  PyArrayObject *docs_obj, *sizes_obj, *titles_obj;
  int num_epochs, max_seq_length, seed, verbose, one_sent;
  long long max_num_samples;
  if (!PyArg_ParseTuple(args, "O!O!O!iLiiii", &PyArray_Type, &docs_obj,
                        &PyArray_Type, &sizes_obj, &PyArray_Type, &titles_obj,
                        &num_epochs, &max_num_samples, &max_seq_length, &seed,
                        &verbose, &one_sent)) {
    return nullptr;
  }
  const int64_t* docs = static_cast<int64_t*>(PyArray_DATA(docs_obj));
  const int32_t* sizes = static_cast<int32_t*>(PyArray_DATA(sizes_obj));
  const int32_t* titles = static_cast<int32_t*>(PyArray_DATA(titles_obj));
  const npy_intp n_docs = PyArray_SIZE(docs_obj) - 1;

  std::vector<int64_t> maps;
  int64_t n_samples = 0;
  for (int epoch = 0; epoch < num_epochs && n_samples < max_num_samples;
       ++epoch) {
    for (npy_intp d = 0; d < n_docs && n_samples < max_num_samples; ++d) {
      const int64_t sent_begin = docs[d];
      const int64_t sent_end = docs[d + 1];
      const int32_t budget = max_seq_length - titles[d];
      if (budget <= 0) continue;
      int64_t start = sent_begin;
      int32_t acc = 0;
      int64_t block_idx = 0;
      for (int64_t s = sent_begin; s < sent_end; ++s) {
        acc += sizes[s];
        const bool last = (s == sent_end - 1);
        if (acc >= budget || last || one_sent) {
          maps.push_back(start);
          maps.push_back(s + 1);
          maps.push_back(d);
          maps.push_back(block_idx++);
          ++n_samples;
          start = s + 1;
          acc = 0;
          if (n_samples >= max_num_samples) break;
        }
      }
    }
  }

  npy_intp dims[2] = {static_cast<npy_intp>(maps.size() / 4), 4};
  PyObject* out = PyArray_SimpleNew(2, dims, NPY_INT64);
  if (!out) return nullptr;
  std::copy(maps.begin(), maps.end(),
            static_cast<int64_t*>(
                PyArray_DATA(reinterpret_cast<PyArrayObject*>(out))));
  return out;
}

PyMethodDef methods[] = {
    {"build_sample_idx", build_sample_idx, METH_VARARGS,
     "sample (doc, offset) index for GPT packing"},
    {"build_blending_indices", build_blending_indices, METH_VARARGS,
     "greedy multi-corpus blending assignment"},
    {"build_mapping", build_mapping, METH_VARARGS,
     "BERT sentence-pair sample map"},
    {"build_blocks_mapping", build_blocks_mapping, METH_VARARGS,
     "ICT/REALM block map"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_data_helpers",
                      "native dataset index builders", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__data_helpers(void) {
  import_array();
  return PyModule_Create(&module);
}
