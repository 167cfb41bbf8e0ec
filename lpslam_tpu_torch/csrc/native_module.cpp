// lpslam_native — C++17 runtime components for the host-side pipeline of
// lpslam_tpu_torch (a copy of lpslam_tpu/native/src/module.cpp; only this
// comment differs).
//
// The tracking compute runs on the GPU; these are native equivalents of the
// host runtime pieces:
//   - BoundedQueue: mutex/condvar bounded queue of PyObjects that releases
//     the GIL while blocking (the role of a TBB concurrent bounded queue);
//   - StreamWriter/StreamReader: the [u64 type][u64 size][payload] framed
//     record stream with buffered file IO;
//   - fast_detect: portable C++ FAST-9/16 corner detector for host-side
//     tooling.
//
// Built with the CPython C API directly (no pybind11), with g++ by
// lpslam_tpu_torch/native/__init__.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// BoundedQueue
// ---------------------------------------------------------------------------

struct QueueObject {
  PyObject_HEAD
  std::deque<PyObject*>* items;
  std::mutex* mu;
  std::condition_variable* not_empty;
  std::condition_variable* not_full;
  Py_ssize_t maxsize;
  bool closed;
};

PyObject* queue_new(PyTypeObject* type, PyObject*, PyObject*) {
  QueueObject* self = reinterpret_cast<QueueObject*>(type->tp_alloc(type, 0));
  if (self) {
    self->items = new std::deque<PyObject*>();
    self->mu = new std::mutex();
    self->not_empty = new std::condition_variable();
    self->not_full = new std::condition_variable();
    self->maxsize = 64;
    self->closed = false;
  }
  return reinterpret_cast<PyObject*>(self);
}

int queue_init(PyObject* selfo, PyObject* args, PyObject* kwds) {
  QueueObject* self = reinterpret_cast<QueueObject*>(selfo);
  Py_ssize_t maxsize = 64;
  static const char* kwlist[] = {"maxsize", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "|n",
                                   const_cast<char**>(kwlist), &maxsize))
    return -1;
  self->maxsize = maxsize > 0 ? maxsize : 1;
  return 0;
}

void queue_dealloc(PyObject* selfo) {
  QueueObject* self = reinterpret_cast<QueueObject*>(selfo);
  for (PyObject* it : *self->items) Py_XDECREF(it);
  delete self->items;
  delete self->mu;
  delete self->not_empty;
  delete self->not_full;
  Py_TYPE(selfo)->tp_free(selfo);
}

PyObject* queue_push(PyObject* selfo, PyObject* args, PyObject* kwds) {
  QueueObject* self = reinterpret_cast<QueueObject*>(selfo);
  PyObject* item;
  double timeout = -1.0;
  int drop_oldest = 0;
  static const char* kwlist[] = {"item", "timeout", "drop_oldest", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "O|dp",
                                   const_cast<char**>(kwlist), &item, &timeout,
                                   &drop_oldest))
    return nullptr;
  Py_INCREF(item);
  PyObject* dropped = nullptr;
  bool pushed = false;
  {
    // release the GIL while waiting for space. The mutex scope must CLOSE
    // before the GIL is reacquired (Py_END_ALLOW_THREADS): holding mu while
    // waiting for the GIL deadlocks against a GIL-holding thread blocked on
    // mu in qsize() (lock-order inversion, found as a wedged RecordEngine
    // drain in the test suite).
    Py_BEGIN_ALLOW_THREADS;
    {
      std::unique_lock<std::mutex> lk(*self->mu);
      auto has_space = [&] {
        return self->closed ||
               static_cast<Py_ssize_t>(self->items->size()) < self->maxsize;
      };
      if (!has_space()) {
        if (drop_oldest) {
          // handled below; DECREF of the dropped item happens with the GIL
        } else if (timeout < 0) {
          self->not_full->wait(lk, has_space);
        } else {
          self->not_full->wait_for(
              lk, std::chrono::duration<double>(timeout), has_space);
        }
      }
      if (!self->closed &&
          static_cast<Py_ssize_t>(self->items->size()) < self->maxsize) {
        self->items->push_back(item);
        pushed = true;
        self->not_empty->notify_one();
      } else if (drop_oldest && !self->closed) {
        if (!self->items->empty()) {
          dropped = self->items->front();
          self->items->pop_front();
        }
        self->items->push_back(item);
        pushed = true;
        self->not_empty->notify_one();
      }
    }
    Py_END_ALLOW_THREADS;
  }
  if (!pushed) Py_DECREF(item);
  Py_XDECREF(dropped);
  return PyBool_FromLong(pushed);
}

PyObject* queue_pop(PyObject* selfo, PyObject* args, PyObject* kwds) {
  QueueObject* self = reinterpret_cast<QueueObject*>(selfo);
  double timeout = -1.0;
  static const char* kwlist[] = {"timeout", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "|d",
                                   const_cast<char**>(kwlist), &timeout))
    return nullptr;
  PyObject* item = nullptr;
  {
    // mutex scope closes before the GIL is reacquired — see queue_push
    Py_BEGIN_ALLOW_THREADS;
    {
      std::unique_lock<std::mutex> lk(*self->mu);
      auto has_item = [&] { return self->closed || !self->items->empty(); };
      if (!has_item()) {
        if (timeout < 0)
          self->not_empty->wait(lk, has_item);
        else
          self->not_empty->wait_for(
              lk, std::chrono::duration<double>(timeout), has_item);
      }
      if (!self->items->empty()) {
        item = self->items->front();
        self->items->pop_front();
        self->not_full->notify_one();
      }
    }
    Py_END_ALLOW_THREADS;
  }
  if (!item) Py_RETURN_NONE;
  return item;  // ownership transferred
}

PyObject* queue_close(PyObject* selfo, PyObject*) {
  QueueObject* self = reinterpret_cast<QueueObject*>(selfo);
  {
    std::lock_guard<std::mutex> lk(*self->mu);
    self->closed = true;
  }
  self->not_empty->notify_all();
  self->not_full->notify_all();
  Py_RETURN_NONE;
}

PyObject* queue_qsize(PyObject* selfo, PyObject*) {
  QueueObject* self = reinterpret_cast<QueueObject*>(selfo);
  std::lock_guard<std::mutex> lk(*self->mu);
  return PyLong_FromSsize_t(static_cast<Py_ssize_t>(self->items->size()));
}

PyMethodDef queue_methods[] = {
    {"push", reinterpret_cast<PyCFunction>(queue_push),
     METH_VARARGS | METH_KEYWORDS, "push(item, timeout=-1, drop_oldest=False)"},
    {"pop", reinterpret_cast<PyCFunction>(queue_pop),
     METH_VARARGS | METH_KEYWORDS, "pop(timeout=-1) -> item | None"},
    {"close", queue_close, METH_NOARGS, "unblock all waiters"},
    {"qsize", queue_qsize, METH_NOARGS, "current size"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject QueueType = {PyVarObject_HEAD_INIT(nullptr, 0)};

// ---------------------------------------------------------------------------
// Framed stream writer / reader
// ---------------------------------------------------------------------------

constexpr uint64_t kMaxMsg = 5000000;

struct WriterObject {
  PyObject_HEAD
  FILE* f;
};

PyObject* writer_new(PyTypeObject* type, PyObject*, PyObject*) {
  WriterObject* self = reinterpret_cast<WriterObject*>(type->tp_alloc(type, 0));
  if (self) self->f = nullptr;
  return reinterpret_cast<PyObject*>(self);
}

int writer_init(PyObject* selfo, PyObject* args, PyObject*) {
  WriterObject* self = reinterpret_cast<WriterObject*>(selfo);
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return -1;
  self->f = std::fopen(path, "wb");
  if (!self->f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return -1;
  }
  return 0;
}

void writer_dealloc(PyObject* selfo) {
  WriterObject* self = reinterpret_cast<WriterObject*>(selfo);
  if (self->f) std::fclose(self->f);
  Py_TYPE(selfo)->tp_free(selfo);
}

PyObject* writer_write(PyObject* selfo, PyObject* args) {
  WriterObject* self = reinterpret_cast<WriterObject*>(selfo);
  unsigned long long msg_type;
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "Ky*", &msg_type, &buf)) return nullptr;
  if (!self->f) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "writer is closed");
    return nullptr;
  }
  if (static_cast<uint64_t>(buf.len) > kMaxMsg) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "message exceeds 5 MB cap");
    return nullptr;
  }
  uint64_t t = msg_type, n = static_cast<uint64_t>(buf.len);
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = std::fwrite(&t, sizeof(t), 1, self->f) == 1 &&
       std::fwrite(&n, sizeof(n), 1, self->f) == 1 &&
       (n == 0 || std::fwrite(buf.buf, 1, n, self->f) == n);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  if (!ok) {
    PyErr_SetString(PyExc_OSError, "short write");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* writer_close(PyObject* selfo, PyObject*) {
  WriterObject* self = reinterpret_cast<WriterObject*>(selfo);
  if (self->f) {
    std::fclose(self->f);
    self->f = nullptr;
  }
  Py_RETURN_NONE;
}

PyMethodDef writer_methods[] = {
    {"write", writer_write, METH_VARARGS, "write(msg_type, payload_bytes)"},
    {"close", writer_close, METH_NOARGS, "close the file"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject WriterType = {PyVarObject_HEAD_INIT(nullptr, 0)};

struct ReaderObject {
  PyObject_HEAD
  FILE* f;
};

PyObject* reader_new(PyTypeObject* type, PyObject*, PyObject*) {
  ReaderObject* self = reinterpret_cast<ReaderObject*>(type->tp_alloc(type, 0));
  if (self) self->f = nullptr;
  return reinterpret_cast<PyObject*>(self);
}

int reader_init(PyObject* selfo, PyObject* args, PyObject*) {
  ReaderObject* self = reinterpret_cast<ReaderObject*>(selfo);
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return -1;
  self->f = std::fopen(path, "rb");
  if (!self->f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return -1;
  }
  return 0;
}

void reader_dealloc(PyObject* selfo) {
  ReaderObject* self = reinterpret_cast<ReaderObject*>(selfo);
  if (self->f) std::fclose(self->f);
  Py_TYPE(selfo)->tp_free(selfo);
}

PyObject* reader_read(PyObject* selfo, PyObject*) {
  ReaderObject* self = reinterpret_cast<ReaderObject*>(selfo);
  if (!self->f) {
    PyErr_SetString(PyExc_ValueError, "reader is closed");
    return nullptr;
  }
  uint64_t t = 0, n = 0;
  size_t got;
  Py_BEGIN_ALLOW_THREADS;
  got = std::fread(&t, sizeof(t), 1, self->f);
  Py_END_ALLOW_THREADS;
  if (got != 1) Py_RETURN_NONE;  // clean EOF
  if (std::fread(&n, sizeof(n), 1, self->f) != 1) Py_RETURN_NONE;
  if (n > kMaxMsg) {
    PyErr_SetString(PyExc_ValueError, "corrupt stream: message too large");
    return nullptr;
  }
  PyObject* payload = PyBytes_FromStringAndSize(nullptr, n);
  if (!payload) return nullptr;
  if (n) {
    bool ok;
    char* dst = PyBytes_AS_STRING(payload);
    Py_BEGIN_ALLOW_THREADS;
    ok = std::fread(dst, 1, n, self->f) == n;
    Py_END_ALLOW_THREADS;
    if (!ok) {
      Py_DECREF(payload);
      Py_RETURN_NONE;  // truncated tail: treat as EOF like the reference
    }
  }
  PyObject* out = Py_BuildValue("KN", t, payload);
  return out;
}

PyMethodDef reader_methods[] = {
    {"read", reader_read, METH_NOARGS, "read() -> (type, bytes) | None at EOF"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject ReaderType = {PyVarObject_HEAD_INIT(nullptr, 0)};

// ---------------------------------------------------------------------------
// FAST-9/16 host detector
// ---------------------------------------------------------------------------

PyObject* fast_detect(PyObject*, PyObject* args) {
  Py_buffer buf;
  int w, h;
  double threshold;
  if (!PyArg_ParseTuple(args, "y*iid", &buf, &w, &h, &threshold)) return nullptr;
  if (static_cast<Py_ssize_t>(w) * h != buf.len) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "buffer size != w*h");
    return nullptr;
  }
  const uint8_t* img = static_cast<const uint8_t*>(buf.buf);
  static const int cdx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  static const int cdy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  std::vector<int> xs, ys;
  std::vector<double> scores;
  Py_BEGIN_ALLOW_THREADS;
  const int t = static_cast<int>(threshold);
  for (int y = 3; y < h - 3; ++y) {
    for (int x = 3; x < w - 3; ++x) {
      const int c = img[y * w + x];
      uint32_t bright = 0, dark = 0;
      double bsum = 0, dsum = 0;
      for (int i = 0; i < 16; ++i) {
        const int v = img[(y + cdy[i]) * w + (x + cdx[i])];
        if (v > c + t) {
          bright |= 1u << i;
          bsum += v - c - t;
        } else if (v < c - t) {
          dark |= 1u << i;
          dsum += c - v - t;
        }
      }
      auto run9 = [](uint32_t m16) {
        uint32_t m = m16 | (m16 << 16);
        uint32_t r = m & (m >> 1);
        r &= r >> 2;
        r &= r >> 4;
        r &= m >> 8;
        return (r & 0xFFFFu) != 0;
      };
      if (run9(bright) || run9(dark)) {
        xs.push_back(x);
        ys.push_back(y);
        scores.push_back(bsum > dsum ? bsum : dsum);
      }
    }
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(xs.size()));
  if (!out) return nullptr;
  for (size_t i = 0; i < xs.size(); ++i) {
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i),
                    Py_BuildValue("iid", xs[i], ys[i], scores[i]));
  }
  return out;
}

PyMethodDef module_methods[] = {
    {"fast_detect", fast_detect, METH_VARARGS,
     "fast_detect(gray_u8_bytes, w, h, threshold) -> [(x, y, score)]"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "lpslam_native",
                         "Native runtime components for lpslam_tpu", -1,
                         module_methods};

}  // namespace

PyMODINIT_FUNC PyInit_lpslam_native() {
  QueueType.tp_name = "lpslam_native.BoundedQueue";
  QueueType.tp_basicsize = sizeof(QueueObject);
  QueueType.tp_flags = Py_TPFLAGS_DEFAULT;
  QueueType.tp_new = queue_new;
  QueueType.tp_init = queue_init;
  QueueType.tp_dealloc = queue_dealloc;
  QueueType.tp_methods = queue_methods;

  WriterType.tp_name = "lpslam_native.StreamWriter";
  WriterType.tp_basicsize = sizeof(WriterObject);
  WriterType.tp_flags = Py_TPFLAGS_DEFAULT;
  WriterType.tp_new = writer_new;
  WriterType.tp_init = writer_init;
  WriterType.tp_dealloc = writer_dealloc;
  WriterType.tp_methods = writer_methods;

  ReaderType.tp_name = "lpslam_native.StreamReader";
  ReaderType.tp_basicsize = sizeof(ReaderObject);
  ReaderType.tp_flags = Py_TPFLAGS_DEFAULT;
  ReaderType.tp_new = reader_new;
  ReaderType.tp_init = reader_init;
  ReaderType.tp_dealloc = reader_dealloc;
  ReaderType.tp_methods = reader_methods;

  if (PyType_Ready(&QueueType) < 0 || PyType_Ready(&WriterType) < 0 ||
      PyType_Ready(&ReaderType) < 0)
    return nullptr;

  PyObject* m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  Py_INCREF(&QueueType);
  PyModule_AddObject(m, "BoundedQueue", reinterpret_cast<PyObject*>(&QueueType));
  Py_INCREF(&WriterType);
  PyModule_AddObject(m, "StreamWriter", reinterpret_cast<PyObject*>(&WriterType));
  Py_INCREF(&ReaderType);
  PyModule_AddObject(m, "StreamReader", reinterpret_cast<PyObject*>(&ReaderType));
  return m;
}
