// XRSLAM C ABI over the PyTorch/CUDA engine (embedded CPython).
//
// The port's copy of native/xr_capi.cpp: the same shim, driving
// xrslam_tpu_torch.capi_host instead of the JAX package's host module.
// Exports the reference's flat C surface (native/XRSLAM.h; reference:
// xrslam-interface/include/XRSLAM.h:195-230,
// xrslam-interface/src/XRSLAMInternal.cpp) by embedding a CPython
// interpreter. The torch device comes from $XRSLAM_TORCH_DEVICE ("cuda"
// by default), read by capi_host.create. Only scalars / bytes /
// str cross the boundary, so this file needs nothing beyond Python.h —
// no numpy headers, no pybind11.
//
// Threading: every entry point takes the GIL via PyGILState_Ensure, so
// the ABI may be called from any thread (the reference manager is also
// a process-wide singleton). If the process already hosts a Python
// interpreter (e.g. the library is dlopen'ed from a Python test via
// ctypes), that interpreter is reused instead of initializing a new one.

#include "XRSLAM.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

std::string g_last_error;
PyObject *g_host = nullptr;  // xrslam_tpu_torch.capi_host module
bool g_owns_interpreter = false;

// persistent result buffers (valid until the next GetResult/Destroy,
// as documented in XRSLAM.h)
std::vector<XRSLAMLandmark> g_landmarks;
std::vector<XRSLAMFeature> g_features;
std::string g_string_out;

void set_error_from_python() {
    PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
    PyErr_Fetch(&type, &value, &trace);
    PyErr_NormalizeException(&type, &value, &trace);
    g_last_error = "python error";
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            const char *c = PyUnicode_AsUTF8(s);
            if (c) g_last_error = c;
            Py_DECREF(s);
        }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(trace);
}

bool ensure_python() {
    if (Py_IsInitialized()) return true;
    Py_InitializeEx(0);
    if (!Py_IsInitialized()) {
        g_last_error = "failed to initialize CPython";
        return false;
    }
    g_owns_interpreter = true;
    // release the GIL acquired by Py_InitializeEx; every entry point
    // re-acquires it via PyGILState_Ensure
    PyEval_SaveThread();
    return true;
}

class Gil {
  public:
    Gil() : state_(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(state_); }

  private:
    PyGILState_STATE state_;
};

// call g_host.<name>(*args); returns new ref or nullptr (error stored)
PyObject *host_call(const char *name, const char *fmt, ...) {
    if (!g_host) {
        g_last_error = "XRSLAMCreate has not succeeded";
        return nullptr;
    }
    PyObject *fn = PyObject_GetAttrString(g_host, name);
    if (!fn) {
        set_error_from_python();
        return nullptr;
    }
    PyObject *args = nullptr;
    if (fmt && *fmt) {
        va_list va;
        va_start(va, fmt);
        args = Py_VaBuildValue(fmt, va);
        va_end(va);
        if (args && !PyTuple_Check(args)) {  // single-arg format
            PyObject *t = PyTuple_Pack(1, args);
            Py_DECREF(args);
            args = t;
        }
    } else {
        args = PyTuple_New(0);
    }
    PyObject *out = args ? PyObject_CallObject(fn, args) : nullptr;
    Py_XDECREF(args);
    Py_DECREF(fn);
    if (!out) set_error_from_python();
    return out;
}

}  // namespace

extern "C" {

int XRSLAMCreate(const char *slam_config_path, const char *device_config_path,
                 const char * /*license_path*/, const char * /*product_name*/,
                 void **config) {
    if (config) *config = nullptr;
    if (!ensure_python()) return 0;
    Gil gil;
    if (!g_host) {
        g_host = PyImport_ImportModule("xrslam_tpu_torch.capi_host");
        if (!g_host) {
            set_error_from_python();
            return 0;
        }
    }
    PyObject *out = host_call("create", "(ss)",
                              slam_config_path ? slam_config_path : "",
                              device_config_path ? device_config_path : "");
    if (!out) return 0;
    long ok = PyLong_AsLong(out);
    Py_DECREF(out);
    if (config && ok == 1) *config = static_cast<void *>(g_host);
    if (ok == 1) g_last_error.clear();
    return ok == 1 ? 1 : 0;
}

void XRSLAMPushSensorData(XRSLAMSensorType sensor_type, void *sensor_data) {
    if (!sensor_data) return;
    Gil gil;
    PyObject *out = nullptr;
    switch (sensor_type) {
    case XRSLAM_SENSOR_CAMERA: {
        const XRSLAMImage *im = static_cast<const XRSLAMImage *>(sensor_data);
        // the image height comes from the device config (the reference
        // manager also gets it there, XRSLAMManager.cpp:55-76); ask the
        // host for the byte count of a stride-wide row block
        out = host_call("camera_bytes", "(i)", im->stride);
        if (!out) return;
        Py_ssize_t nbytes = PyLong_AsSsize_t(out);
        Py_DECREF(out);
        PyObject *buf = PyBytes_FromStringAndSize(
            reinterpret_cast<const char *>(im->data), nbytes);
        if (!buf) {
            set_error_from_python();
            return;
        }
        PyObject *fn = PyObject_GetAttrString(g_host, "push_camera");
        out = nullptr;
        if (fn) {
            out = PyObject_CallFunction(fn, "dOii", im->timeStamp, buf,
                                        im->stride, im->channel);
            Py_DECREF(fn);
        }
        Py_DECREF(buf);
        break;
    }
    case XRSLAM_SENSOR_DEPTH_CAMERA: {
        const XRSLAMDepthImage *d =
            static_cast<const XRSLAMDepthImage *>(sensor_data);
        PyObject *nb = host_call("depth_bytes", "");
        if (!nb) return;
        Py_ssize_t nbytes = PyLong_AsSsize_t(nb);
        Py_DECREF(nb);
        PyObject *buf = PyBytes_FromStringAndSize(
            reinterpret_cast<const char *>(d->data), nbytes);
        if (!buf) {
            set_error_from_python();
            return;
        }
        PyObject *fn = PyObject_GetAttrString(g_host, "push_depth");
        out = nullptr;
        if (fn) {
            out = PyObject_CallFunction(fn, "dO", d->timeStamp, buf);
            Py_DECREF(fn);
        }
        Py_DECREF(buf);
        break;
    }
    case XRSLAM_SENSOR_ACCELERATION: {
        const XRSLAMAcceleration *a =
            static_cast<const XRSLAMAcceleration *>(sensor_data);
        out = host_call("push_imu", "(idddd)", (int)XRSLAM_SENSOR_ACCELERATION,
                        a->timestamp, a->data[0], a->data[1], a->data[2]);
        break;
    }
    case XRSLAM_SENSOR_GYROSCOPE: {
        const XRSLAMGyroscope *g =
            static_cast<const XRSLAMGyroscope *>(sensor_data);
        out = host_call("push_imu", "(idddd)", (int)XRSLAM_SENSOR_GYROSCOPE,
                        g->timestamp, g->data[0], g->data[1], g->data[2]);
        break;
    }
    default:
        g_last_error = "unsupported sensor type";
        return;
    }
    if (!out) set_error_from_python();
    Py_XDECREF(out);
}

void XRSLAMRunOneFrame(void) {
    Gil gil;
    PyObject *out = host_call("run_one_frame", "");
    Py_XDECREF(out);
}

void XRSLAMSetViewer(void * /*viewer*/) {}

void XRSLAMGetResult(XRSLAMResultType result_type, void *result_data) {
    if (!result_data) return;
    Gil gil;
    switch (result_type) {
    case XRSLAM_RESULT_BODY_POSE:
    case XRSLAM_RESULT_CAMERA_POSE: {
        PyObject *out = host_call("get_pose", "(i)", (int)result_type);
        if (!out) return;
        XRSLAMPose *p = static_cast<XRSLAMPose *>(result_data);
        double v[8] = {0, 0, 0, 1, 0, 0, 0, 0};
        for (int i = 0; i < 8; ++i)
            v[i] = PyFloat_AsDouble(PyTuple_GetItem(out, i));
        Py_DECREF(out);
        for (int i = 0; i < 4; ++i) p->quaternion[i] = v[i];
        for (int i = 0; i < 3; ++i) p->translation[i] = v[4 + i];
        p->timestamp = v[7];
        break;
    }
    case XRSLAM_RESULT_STATE: {
        PyObject *out = host_call("get_state", "");
        if (!out) return;
        *static_cast<XRSLAMState *>(result_data) =
            static_cast<XRSLAMState>(PyLong_AsLong(out));
        Py_DECREF(out);
        break;
    }
    case XRSLAM_RESULT_LANDMARKS: {
        PyObject *out = host_call("get_landmarks", "");
        if (!out) return;
        char *raw = nullptr;
        Py_ssize_t n = 0;
        PyBytes_AsStringAndSize(out, &raw, &n);
        size_t cnt = n / (3 * sizeof(double));
        g_landmarks.resize(cnt);
        if (cnt) std::memcpy(g_landmarks.data(), raw, cnt * 3 * sizeof(double));
        Py_DECREF(out);
        XRSLAMLandmarks *lm = static_cast<XRSLAMLandmarks *>(result_data);
        lm->landmarks = g_landmarks.data();
        lm->num_landmarks = static_cast<int>(cnt);
        break;
    }
    case XRSLAM_RESULT_FEATURES: {
        PyObject *out = host_call("get_features", "");
        if (!out) return;
        char *raw = nullptr;
        Py_ssize_t n = 0;
        PyBytes_AsStringAndSize(out, &raw, &n);
        size_t cnt = n / (2 * sizeof(double));
        g_features.resize(cnt);
        if (cnt) std::memcpy(g_features.data(), raw, cnt * 2 * sizeof(double));
        Py_DECREF(out);
        XRSLAMFeatures *f = static_cast<XRSLAMFeatures *>(result_data);
        f->features = g_features.data();
        f->num_features = static_cast<int>(cnt);
        break;
    }
    case XRSLAM_RESULT_BIAS: {
        PyObject *out = host_call("get_bias", "");
        if (!out) return;
        XRSLAMIMUBias *b = static_cast<XRSLAMIMUBias *>(result_data);
        for (int i = 0; i < 3; ++i)
            b->acc_bias.data[i] = PyFloat_AsDouble(PyTuple_GetItem(out, i));
        for (int i = 0; i < 3; ++i)
            b->gyr_bias.data[i] = PyFloat_AsDouble(PyTuple_GetItem(out, 3 + i));
        Py_DECREF(out);
        break;
    }
    case XRSLAM_INFO_INTRINSICS: {
        PyObject *out = host_call("get_intrinsics", "");
        if (!out) return;
        XRSLAMIntrinsics *k = static_cast<XRSLAMIntrinsics *>(result_data);
        k->fx = PyFloat_AsDouble(PyTuple_GetItem(out, 0));
        k->fy = PyFloat_AsDouble(PyTuple_GetItem(out, 1));
        k->cx = PyFloat_AsDouble(PyTuple_GetItem(out, 2));
        k->cy = PyFloat_AsDouble(PyTuple_GetItem(out, 3));
        Py_DECREF(out);
        break;
    }
    case XRSLAM_RESULT_VERSION:
    case XRSLAM_RESULT_DEBUG_LOGS: {
        PyObject *out = host_call(result_type == XRSLAM_RESULT_VERSION
                                      ? "get_version"
                                      : "get_debug_logs",
                                  "");
        if (!out) return;
        const char *s = PyUnicode_AsUTF8(out);
        g_string_out = s ? s : "";
        Py_DECREF(out);
        XRSLAMStringOutput *so = static_cast<XRSLAMStringOutput *>(result_data);
        so->data = const_cast<char *>(g_string_out.c_str());
        so->str_length = static_cast<int>(g_string_out.size());
        break;
    }
    default:
        g_last_error = "unsupported result type";
        break;
    }
}

void XRSLAMDestroy(void) {
    Gil gil;
    PyObject *out = host_call("destroy", "");
    Py_XDECREF(out);
    g_landmarks.clear();
    g_features.clear();
    g_string_out.clear();
    // the interpreter (and the CUDA runtime inside it) stays alive for
    // a potential later XRSLAMCreate; finalizing CPython with live
    // accelerator runtimes is unsafe
}

const char *XRSLAMGetLastError(void) { return g_last_error.c_str(); }

}  // extern "C"
