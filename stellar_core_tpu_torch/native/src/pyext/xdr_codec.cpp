// _scxdr: native XDR codec — a schema-program interpreter for the
// declarative XDR runtime (stellar_core_tpu/xdr/runtime.py).
//
// The Python runtime compiles its Struct/Union/type graph into a flat
// node program (see xdr/native_codec.py); this extension interprets
// that program to pack (canonical RFC 4506 bytes), unpack (strict:
// canonical padding, enum/bool/optional validation) and deep-copy XDR
// values at C speed.  It replaces the exec-specialized Python codecs
// on the apply hot path (reference equivalent: xdrpp's generated C++
// codecs, src/Makefile.am:46-51) while keeping byte-identical output —
// the Python runtime remains the semantic oracle and the fallback.
//
// No Python behavior lives here beyond the wire format: error cases
// raise XdrError (class supplied at build time) and callers fall back
// to the Python path to produce field-attributed messages.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>

enum Kind {
    K_I32 = 0,
    K_U32 = 1,
    K_I64 = 2,
    K_U64 = 3,
    K_BOOL = 4,
    K_OPAQUE = 5,
    K_VAROPAQUE = 6,
    K_ARRAY = 7,
    K_VARARRAY = 8,
    K_OPT = 9,
    K_ENUM = 10,
    K_STRUCT = 11,
    K_UNION = 12,
};

#define MAX_DEPTH 256

struct Node {
    int kind;
    long long n;        // opaque/varopaque/array/vararray: len or max len
    int a;              // array/vararray/opt: element node index
    int sw;             // union: switch node index
    int nf;             // struct: field count
    PyObject *cls;      // enum/struct/union class (strong ref)
    PyObject *map;      // enum: {int: member}; union: {int: (name, idx)}
    PyObject *names;    // struct: tuple of interned field-name strings
    int *fidx;          // struct: field node indices (length nf)
    PyObject *udefault; // union default arm: NULL missing, Py_None void,
                        // tuple (name_or_None, idx_or_-1)
};

struct Prog {
    Node *nodes;
    int n;
    PyObject *xdr_error;
};

static PyObject *g_empty_tuple;
static PyObject *g_str_disc, *g_str_arm_name, *g_str_value;

// ---------------------------------------------------------------------------
// Buffers
// ---------------------------------------------------------------------------

struct WBuf {
    uint8_t *p;
    Py_ssize_t len, cap;
};

static int wb_grow(WBuf *w, Py_ssize_t extra) {
    Py_ssize_t nc = w->cap ? w->cap : 256;
    while (nc < w->len + extra)
        nc *= 2;
    uint8_t *np = (uint8_t *)realloc(w->p, (size_t)nc);
    if (!np) {
        PyErr_NoMemory();
        return -1;
    }
    w->p = np;
    w->cap = nc;
    return 0;
}

static inline int wb_need(WBuf *w, Py_ssize_t extra) {
    if (w->len + extra <= w->cap)
        return 0;
    return wb_grow(w, extra);
}

static inline void be32(uint8_t *d, uint32_t v) {
    d[0] = (uint8_t)(v >> 24);
    d[1] = (uint8_t)(v >> 16);
    d[2] = (uint8_t)(v >> 8);
    d[3] = (uint8_t)v;
}

static inline void be64(uint8_t *d, uint64_t v) {
    be32(d, (uint32_t)(v >> 32));
    be32(d + 4, (uint32_t)v);
}

static inline uint32_t rd32(const uint8_t *d) {
    return ((uint32_t)d[0] << 24) | ((uint32_t)d[1] << 16) |
           ((uint32_t)d[2] << 8) | (uint32_t)d[3];
}

static inline uint64_t rd64(const uint8_t *d) {
    return ((uint64_t)rd32(d) << 32) | rd32(d + 4);
}

struct RBuf {
    const uint8_t *p;
    Py_ssize_t len, pos;
};

static inline const uint8_t *r_take(Prog *pr, RBuf *r, Py_ssize_t n) {
    if (n > r->len - r->pos) {
        PyErr_SetString(pr->xdr_error, "unexpected end of XDR input");
        return NULL;
    }
    const uint8_t *out = r->p + r->pos;
    r->pos += n;
    return out;
}

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

// int(v): exact PyLong or subclass passes through, otherwise __int__-style
// conversion matching the Python runtime's `int(v)` calls
static PyObject *to_pylong(PyObject *v) {
    if (PyLong_Check(v)) {
        Py_INCREF(v);
        return v;
    }
    return PyNumber_Long(v);
}

static int as_i64(Prog *pr, PyObject *v, long long *out, const char *what) {
    PyObject *lv = to_pylong(v);
    if (!lv)
        return -1;
    int ovf = 0;
    long long x = PyLong_AsLongLongAndOverflow(lv, &ovf);
    Py_DECREF(lv);
    if (x == -1 && PyErr_Occurred())
        return -1;
    if (ovf) {
        PyErr_Format(pr->xdr_error, "%s out of range", what);
        return -1;
    }
    *out = x;
    return 0;
}

static int as_u64(Prog *pr, PyObject *v, unsigned long long *out) {
    PyObject *lv = to_pylong(v);
    if (!lv)
        return -1;
    unsigned long long x = PyLong_AsUnsignedLongLong(lv);
    Py_DECREF(lv);
    if (x == (unsigned long long)-1 && PyErr_Occurred()) {
        if (PyErr_ExceptionMatches(PyExc_OverflowError)) {
            PyErr_Clear();
            PyErr_SetString(pr->xdr_error, "uint64 out of range");
        }
        return -1;
    }
    *out = x;
    return 0;
}

// value as bytes: PyBytes passes through (borrowed->new ref), other
// buffer-likes snapshot via bytes(v) semantics
static PyObject *as_bytes(PyObject *v) {
    if (PyBytes_Check(v)) {
        Py_INCREF(v);
        return v;
    }
    return PyBytes_FromObject(v);
}

static PyObject *new_instance(PyObject *cls) {
    PyTypeObject *tp = (PyTypeObject *)cls;
    return tp->tp_new(tp, g_empty_tuple, NULL);
}

// ---------------------------------------------------------------------------
// Pack
// ---------------------------------------------------------------------------

static int pack_node(Prog *pr, int idx, PyObject *v, WBuf *w, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(pr->xdr_error, "XDR nesting too deep");
        return -1;
    }
    Node *nd = &pr->nodes[idx];
    switch (nd->kind) {
    case K_I32: {
        long long x;
        if (as_i64(pr, v, &x, "int32"))
            return -1;
        if (x < INT32_MIN || x > INT32_MAX) {
            PyErr_Format(pr->xdr_error, "int32 out of range: %lld", x);
            return -1;
        }
        if (wb_need(w, 4))
            return -1;
        be32(w->p + w->len, (uint32_t)(int32_t)x);
        w->len += 4;
        return 0;
    }
    case K_U32: {
        long long x;
        if (as_i64(pr, v, &x, "uint32"))
            return -1;
        if (x < 0 || x > 0xFFFFFFFFLL) {
            PyErr_Format(pr->xdr_error, "uint32 out of range: %lld", x);
            return -1;
        }
        if (wb_need(w, 4))
            return -1;
        be32(w->p + w->len, (uint32_t)x);
        w->len += 4;
        return 0;
    }
    case K_I64: {
        long long x;
        if (as_i64(pr, v, &x, "int64"))
            return -1;
        if (wb_need(w, 8))
            return -1;
        be64(w->p + w->len, (uint64_t)x);
        w->len += 8;
        return 0;
    }
    case K_U64: {
        unsigned long long x;
        if (as_u64(pr, v, &x))
            return -1;
        if (wb_need(w, 8))
            return -1;
        be64(w->p + w->len, x);
        w->len += 8;
        return 0;
    }
    case K_BOOL: {
        int t = PyObject_IsTrue(v);
        if (t < 0)
            return -1;
        if (wb_need(w, 4))
            return -1;
        be32(w->p + w->len, (uint32_t)t);
        w->len += 4;
        return 0;
    }
    case K_OPAQUE:
    case K_VAROPAQUE: {
        PyObject *b = as_bytes(v);
        if (!b)
            return -1;
        Py_ssize_t bl = PyBytes_GET_SIZE(b);
        if (nd->kind == K_OPAQUE) {
            if (bl != nd->n) {
                Py_DECREF(b);
                PyErr_Format(pr->xdr_error, "opaque[%lld] got %zd bytes",
                             nd->n, bl);
                return -1;
            }
        } else {
            if (bl > nd->n) {
                Py_DECREF(b);
                PyErr_Format(pr->xdr_error, "opaque<%lld> got %zd bytes",
                             nd->n, bl);
                return -1;
            }
        }
        Py_ssize_t pad = (-bl) & 3;
        Py_ssize_t hdr = (nd->kind == K_VAROPAQUE) ? 4 : 0;
        if (wb_need(w, hdr + bl + pad)) {
            Py_DECREF(b);
            return -1;
        }
        uint8_t *d = w->p + w->len;
        if (hdr) {
            be32(d, (uint32_t)bl);
            d += 4;
        }
        memcpy(d, PyBytes_AS_STRING(b), (size_t)bl);
        if (pad)
            memset(d + bl, 0, (size_t)pad);
        w->len += hdr + bl + pad;
        Py_DECREF(b);
        return 0;
    }
    case K_ARRAY:
    case K_VARARRAY: {
        PyObject *seq = PySequence_Fast(v, "expected a sequence");
        if (!seq)
            return -1;
        Py_ssize_t ln = PySequence_Fast_GET_SIZE(seq);
        if (nd->kind == K_ARRAY) {
            if (ln != nd->n) {
                Py_DECREF(seq);
                PyErr_Format(pr->xdr_error, "array[%lld] got %zd elements",
                             nd->n, ln);
                return -1;
            }
        } else {
            if (ln > nd->n) {
                Py_DECREF(seq);
                PyErr_Format(pr->xdr_error, "array<%lld> got %zd elements",
                             nd->n, ln);
                return -1;
            }
            if (wb_need(w, 4)) {
                Py_DECREF(seq);
                return -1;
            }
            be32(w->p + w->len, (uint32_t)ln);
            w->len += 4;
        }
        PyObject **items = PySequence_Fast_ITEMS(seq);
        for (Py_ssize_t i = 0; i < ln; i++) {
            if (pack_node(pr, nd->a, items[i], w, depth + 1)) {
                Py_DECREF(seq);
                return -1;
            }
        }
        Py_DECREF(seq);
        return 0;
    }
    case K_OPT: {
        if (wb_need(w, 4))
            return -1;
        if (v == Py_None) {
            be32(w->p + w->len, 0);
            w->len += 4;
            return 0;
        }
        be32(w->p + w->len, 1);
        w->len += 4;
        return pack_node(pr, nd->a, v, w, depth + 1);
    }
    case K_ENUM: {
        long long x;
        if ((PyObject *)Py_TYPE(v) == nd->cls) {
            // already a member of this enum: trusted
            if (as_i64(pr, v, &x, "enum"))
                return -1;
        } else {
            if (as_i64(pr, v, &x, "enum"))
                return -1;
            PyObject *key = PyLong_FromLongLong(x);
            if (!key)
                return -1;
            PyObject *m = PyDict_GetItemWithError(nd->map, key);
            Py_DECREF(key);
            if (!m) {
                if (!PyErr_Occurred())
                    PyErr_Format(pr->xdr_error, "invalid enum value %lld", x);
                return -1;
            }
        }
        if (x < INT32_MIN || x > INT32_MAX) {
            PyErr_Format(pr->xdr_error, "enum out of int32 range: %lld", x);
            return -1;
        }
        if (wb_need(w, 4))
            return -1;
        be32(w->p + w->len, (uint32_t)(int32_t)x);
        w->len += 4;
        return 0;
    }
    case K_STRUCT: {
        if ((PyObject *)Py_TYPE(v) != nd->cls) {
            int ok = PyObject_IsInstance(v, nd->cls);
            if (ok < 0)
                return -1;
            if (!ok) {
                PyErr_Format(pr->xdr_error, "expected %s, got %s",
                             ((PyTypeObject *)nd->cls)->tp_name,
                             Py_TYPE(v)->tp_name);
                return -1;
            }
        }
        for (int i = 0; i < nd->nf; i++) {
            PyObject *fv =
                PyObject_GetAttr(v, PyTuple_GET_ITEM(nd->names, i));
            if (!fv)
                return -1;
            int r = pack_node(pr, nd->fidx[i], fv, w, depth + 1);
            Py_DECREF(fv);
            if (r)
                return -1;
        }
        return 0;
    }
    case K_UNION: {
        PyObject *disc = PyObject_GetAttr(v, g_str_disc);
        if (!disc)
            return -1;
        if (pack_node(pr, nd->sw, disc, w, depth + 1)) {
            Py_DECREF(disc);
            return -1;
        }
        long long dv;
        int r = as_i64(pr, disc, &dv, "discriminant");
        Py_DECREF(disc);
        if (r)
            return -1;
        PyObject *key = PyLong_FromLongLong(dv);
        if (!key)
            return -1;
        PyObject *arm = PyDict_GetItemWithError(nd->map, key);
        Py_DECREF(key);
        int elem = -1;
        if (arm) {
            elem = (int)PyLong_AsLong(PyTuple_GET_ITEM(arm, 1));
        } else {
            if (PyErr_Occurred())
                return -1;
            if (nd->udefault == NULL) {
                PyErr_Format(pr->xdr_error, "invalid discriminant %lld", dv);
                return -1;
            }
            if (nd->udefault != Py_None)
                elem = (int)PyLong_AsLong(
                    PyTuple_GET_ITEM(nd->udefault, 1));
        }
        if (elem >= 0) {
            PyObject *val = PyObject_GetAttr(v, g_str_value);
            if (!val)
                return -1;
            r = pack_node(pr, elem, val, w, depth + 1);
            Py_DECREF(val);
            if (r)
                return -1;
        }
        return 0;
    }
    }
    PyErr_SetString(PyExc_SystemError, "corrupt XDR program node");
    return -1;
}

// ---------------------------------------------------------------------------
// Unpack
// ---------------------------------------------------------------------------

static PyObject *unpack_node(Prog *pr, int idx, RBuf *r, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(pr->xdr_error, "XDR nesting too deep");
        return NULL;
    }
    Node *nd = &pr->nodes[idx];
    switch (nd->kind) {
    case K_I32: {
        const uint8_t *d = r_take(pr, r, 4);
        if (!d)
            return NULL;
        return PyLong_FromLong((long)(int32_t)rd32(d));
    }
    case K_U32: {
        const uint8_t *d = r_take(pr, r, 4);
        if (!d)
            return NULL;
        return PyLong_FromUnsignedLong(rd32(d));
    }
    case K_I64: {
        const uint8_t *d = r_take(pr, r, 8);
        if (!d)
            return NULL;
        return PyLong_FromLongLong((long long)(int64_t)rd64(d));
    }
    case K_U64: {
        const uint8_t *d = r_take(pr, r, 8);
        if (!d)
            return NULL;
        return PyLong_FromUnsignedLongLong(rd64(d));
    }
    case K_BOOL: {
        const uint8_t *d = r_take(pr, r, 4);
        if (!d)
            return NULL;
        uint32_t x = rd32(d);
        if (x > 1) {
            PyErr_Format(pr->xdr_error, "invalid bool encoding %u", x);
            return NULL;
        }
        PyObject *res = x ? Py_True : Py_False;
        Py_INCREF(res);
        return res;
    }
    case K_OPAQUE:
    case K_VAROPAQUE: {
        Py_ssize_t n;
        if (nd->kind == K_OPAQUE) {
            n = (Py_ssize_t)nd->n;
        } else {
            const uint8_t *d = r_take(pr, r, 4);
            if (!d)
                return NULL;
            uint32_t x = rd32(d);
            if ((long long)x > nd->n) {
                PyErr_Format(pr->xdr_error, "opaque<%lld> got %u bytes",
                             nd->n, x);
                return NULL;
            }
            n = (Py_ssize_t)x;
        }
        const uint8_t *d = r_take(pr, r, n);
        if (!d)
            return NULL;
        Py_ssize_t pad = (-n) & 3;
        if (pad) {
            const uint8_t *pp = r_take(pr, r, pad);
            if (!pp)
                return NULL;
            for (Py_ssize_t i = 0; i < pad; i++) {
                if (pp[i]) {
                    PyErr_SetString(pr->xdr_error, "non-zero XDR padding");
                    return NULL;
                }
            }
        }
        return PyBytes_FromStringAndSize((const char *)d, n);
    }
    case K_ARRAY:
    case K_VARARRAY: {
        Py_ssize_t n;
        if (nd->kind == K_ARRAY) {
            n = (Py_ssize_t)nd->n;
        } else {
            const uint8_t *d = r_take(pr, r, 4);
            if (!d)
                return NULL;
            uint32_t x = rd32(d);
            if ((long long)x > nd->n) {
                PyErr_Format(pr->xdr_error, "array<%lld> got %u elements",
                             nd->n, x);
                return NULL;
            }
            n = (Py_ssize_t)x;
        }
        // build incrementally: a hostile length prefix fails on the
        // first short element read instead of a giant preallocation
        PyObject *lst = PyList_New(0);
        if (!lst)
            return NULL;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *e = unpack_node(pr, nd->a, r, depth + 1);
            if (!e || PyList_Append(lst, e)) {
                Py_XDECREF(e);
                Py_DECREF(lst);
                return NULL;
            }
            Py_DECREF(e);
        }
        return lst;
    }
    case K_OPT: {
        const uint8_t *d = r_take(pr, r, 4);
        if (!d)
            return NULL;
        uint32_t flag = rd32(d);
        if (flag == 0)
            Py_RETURN_NONE;
        if (flag != 1) {
            PyErr_Format(pr->xdr_error, "invalid optional flag %u", flag);
            return NULL;
        }
        return unpack_node(pr, nd->a, r, depth + 1);
    }
    case K_ENUM: {
        const uint8_t *d = r_take(pr, r, 4);
        if (!d)
            return NULL;
        long raw = (long)(int32_t)rd32(d);
        PyObject *key = PyLong_FromLong(raw);
        if (!key)
            return NULL;
        PyObject *m = PyDict_GetItemWithError(nd->map, key);
        Py_DECREF(key);
        if (!m) {
            if (!PyErr_Occurred())
                PyErr_Format(pr->xdr_error, "invalid enum value %ld", raw);
            return NULL;
        }
        Py_INCREF(m);
        return m;
    }
    case K_STRUCT: {
        PyObject *obj = new_instance(nd->cls);
        if (!obj)
            return NULL;
        for (int i = 0; i < nd->nf; i++) {
            PyObject *fv = unpack_node(pr, nd->fidx[i], r, depth + 1);
            if (!fv) {
                Py_DECREF(obj);
                return NULL;
            }
            int rr = PyObject_SetAttr(obj, PyTuple_GET_ITEM(nd->names, i),
                                      fv);
            Py_DECREF(fv);
            if (rr) {
                Py_DECREF(obj);
                return NULL;
            }
        }
        return obj;
    }
    case K_UNION: {
        PyObject *disc = unpack_node(pr, nd->sw, r, depth + 1);
        if (!disc)
            return NULL;
        long long dv;
        if (as_i64(pr, disc, &dv, "discriminant")) {
            Py_DECREF(disc);
            return NULL;
        }
        PyObject *key = PyLong_FromLongLong(dv);
        if (!key) {
            Py_DECREF(disc);
            return NULL;
        }
        PyObject *arm = PyDict_GetItemWithError(nd->map, key);
        Py_DECREF(key);
        PyObject *an = Py_None;
        int elem = -1;
        if (arm) {
            an = PyTuple_GET_ITEM(arm, 0);
            elem = (int)PyLong_AsLong(PyTuple_GET_ITEM(arm, 1));
        } else {
            if (PyErr_Occurred()) {
                Py_DECREF(disc);
                return NULL;
            }
            if (nd->udefault == NULL) {
                PyErr_Format(pr->xdr_error, "invalid discriminant %lld", dv);
                Py_DECREF(disc);
                return NULL;
            }
            if (nd->udefault != Py_None) {
                an = PyTuple_GET_ITEM(nd->udefault, 0);
                elem = (int)PyLong_AsLong(
                    PyTuple_GET_ITEM(nd->udefault, 1));
            }
        }
        PyObject *obj = new_instance(nd->cls);
        if (!obj) {
            Py_DECREF(disc);
            return NULL;
        }
        int rr = PyObject_SetAttr(obj, g_str_disc, disc);
        Py_DECREF(disc);
        if (rr)
            goto union_fail;
        if (PyObject_SetAttr(obj, g_str_arm_name, an))
            goto union_fail;
        if (elem >= 0) {
            PyObject *val = unpack_node(pr, elem, r, depth + 1);
            if (!val)
                goto union_fail;
            rr = PyObject_SetAttr(obj, g_str_value, val);
            Py_DECREF(val);
            if (rr)
                goto union_fail;
        } else {
            if (PyObject_SetAttr(obj, g_str_value, Py_None))
                goto union_fail;
        }
        return obj;
    union_fail:
        Py_DECREF(obj);
        return NULL;
    }
    }
    PyErr_SetString(PyExc_SystemError, "corrupt XDR program node");
    return NULL;
}

// ---------------------------------------------------------------------------
// Clone (structural deep copy; immutable leaves shared)
// ---------------------------------------------------------------------------

static PyObject *clone_node(Prog *pr, int idx, PyObject *v, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(pr->xdr_error, "XDR nesting too deep");
        return NULL;
    }
    Node *nd = &pr->nodes[idx];
    switch (nd->kind) {
    case K_I32:
    case K_U32:
    case K_I64:
    case K_U64:
    case K_BOOL:
    case K_ENUM:
        Py_INCREF(v);
        return v;
    case K_OPAQUE:
    case K_VAROPAQUE:
        return as_bytes(v); // bytes shared, mutable buffers snapshot
    case K_ARRAY:
    case K_VARARRAY: {
        PyObject *seq = PySequence_Fast(v, "expected a sequence");
        if (!seq)
            return NULL;
        Py_ssize_t ln = PySequence_Fast_GET_SIZE(seq);
        PyObject *lst = PyList_New(ln);
        if (!lst) {
            Py_DECREF(seq);
            return NULL;
        }
        PyObject **items = PySequence_Fast_ITEMS(seq);
        for (Py_ssize_t i = 0; i < ln; i++) {
            PyObject *e = clone_node(pr, nd->a, items[i], depth + 1);
            if (!e) {
                Py_DECREF(lst);
                Py_DECREF(seq);
                return NULL;
            }
            PyList_SET_ITEM(lst, i, e);
        }
        Py_DECREF(seq);
        return lst;
    }
    case K_OPT: {
        if (v == Py_None)
            Py_RETURN_NONE;
        return clone_node(pr, nd->a, v, depth + 1);
    }
    case K_STRUCT: {
        PyObject *obj = new_instance(nd->cls);
        if (!obj)
            return NULL;
        for (int i = 0; i < nd->nf; i++) {
            PyObject *name = PyTuple_GET_ITEM(nd->names, i);
            PyObject *fv = PyObject_GetAttr(v, name);
            if (!fv) {
                Py_DECREF(obj);
                return NULL;
            }
            PyObject *cv = clone_node(pr, nd->fidx[i], fv, depth + 1);
            Py_DECREF(fv);
            if (!cv) {
                Py_DECREF(obj);
                return NULL;
            }
            int rr = PyObject_SetAttr(obj, name, cv);
            Py_DECREF(cv);
            if (rr) {
                Py_DECREF(obj);
                return NULL;
            }
        }
        return obj;
    }
    case K_UNION: {
        PyObject *disc = PyObject_GetAttr(v, g_str_disc);
        if (!disc)
            return NULL;
        long long dv;
        if (as_i64(pr, disc, &dv, "discriminant")) {
            Py_DECREF(disc);
            return NULL;
        }
        PyObject *key = PyLong_FromLongLong(dv);
        if (!key) {
            Py_DECREF(disc);
            return NULL;
        }
        PyObject *arm = PyDict_GetItemWithError(nd->map, key);
        Py_DECREF(key);
        int elem = -1;
        if (arm) {
            elem = (int)PyLong_AsLong(PyTuple_GET_ITEM(arm, 1));
        } else {
            if (PyErr_Occurred()) {
                Py_DECREF(disc);
                return NULL;
            }
            if (nd->udefault == NULL) {
                // unknown discriminant on a default-less union: the
                // Python generic clone handles it; signal fallback
                PyErr_Format(pr->xdr_error, "invalid discriminant %lld",
                             dv);
                Py_DECREF(disc);
                return NULL;
            }
            if (nd->udefault != Py_None)
                elem = (int)PyLong_AsLong(
                    PyTuple_GET_ITEM(nd->udefault, 1));
        }
        PyObject *obj = new_instance(nd->cls);
        if (!obj) {
            Py_DECREF(disc);
            return NULL;
        }
        int rr = PyObject_SetAttr(obj, g_str_disc, disc);
        Py_DECREF(disc);
        if (rr)
            goto uclone_fail;
        {
            PyObject *an = PyObject_GetAttr(v, g_str_arm_name);
            if (!an)
                goto uclone_fail;
            rr = PyObject_SetAttr(obj, g_str_arm_name, an);
            Py_DECREF(an);
            if (rr)
                goto uclone_fail;
        }
        {
            PyObject *val = PyObject_GetAttr(v, g_str_value);
            if (!val)
                goto uclone_fail;
            PyObject *cv;
            if (elem >= 0 && val != Py_None) {
                cv = clone_node(pr, elem, val, depth + 1);
            } else {
                cv = val;
                Py_INCREF(cv);
            }
            Py_DECREF(val);
            if (!cv)
                goto uclone_fail;
            rr = PyObject_SetAttr(obj, g_str_value, cv);
            Py_DECREF(cv);
            if (rr)
                goto uclone_fail;
        }
        return obj;
    uclone_fail:
        Py_DECREF(obj);
        return NULL;
    }
    default:
        Py_INCREF(v);
        return v;
    }
}

// ---------------------------------------------------------------------------
// Program construction / module surface
// ---------------------------------------------------------------------------

static void prog_destroy(PyObject *capsule) {
    Prog *p = (Prog *)PyCapsule_GetPointer(capsule, "scxdr.prog");
    if (!p)
        return;
    for (int i = 0; i < p->n; i++) {
        Node *nd = &p->nodes[i];
        Py_XDECREF(nd->cls);
        Py_XDECREF(nd->map);
        Py_XDECREF(nd->names);
        Py_XDECREF(nd->udefault);
        free(nd->fidx);
    }
    free(p->nodes);
    Py_XDECREF(p->xdr_error);
    free(p);
}

static int check_idx(long long v, int n, const char *what) {
    if (v < 0 || v >= n) {
        PyErr_Format(PyExc_ValueError, "bad %s node index %lld", what, v);
        return -1;
    }
    return 0;
}

static PyObject *mod_build(PyObject *self, PyObject *args) {
    PyObject *lst, *xdr_error;
    if (!PyArg_ParseTuple(args, "O!O", &PyList_Type, &lst, &xdr_error))
        return NULL;
    int n = (int)PyList_GET_SIZE(lst);
    Prog *p = (Prog *)calloc(1, sizeof(Prog));
    if (!p)
        return PyErr_NoMemory();
    p->nodes = (Node *)calloc((size_t)(n ? n : 1), sizeof(Node));
    if (!p->nodes) {
        free(p);
        return PyErr_NoMemory();
    }
    p->n = n;
    Py_INCREF(xdr_error);
    p->xdr_error = xdr_error;

    PyObject *capsule = PyCapsule_New(p, "scxdr.prog", prog_destroy);
    if (!capsule) {
        Py_DECREF(p->xdr_error);
        free(p->nodes);
        free(p);
        return NULL;
    }

    for (int i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(lst, i);
        Node *nd = &p->nodes[i];
        long long kind;
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) < 1)
            goto bad;
        kind = PyLong_AsLongLong(PyTuple_GET_ITEM(item, 0));
        if (kind == -1 && PyErr_Occurred())
            goto fail;
        nd->kind = (int)kind;
        switch (nd->kind) {
        case K_I32:
        case K_U32:
        case K_I64:
        case K_U64:
        case K_BOOL:
            break;
        case K_OPAQUE:
        case K_VAROPAQUE:
            if (PyTuple_GET_SIZE(item) != 2)
                goto bad;
            nd->n = PyLong_AsLongLong(PyTuple_GET_ITEM(item, 1));
            if (nd->n == -1 && PyErr_Occurred())
                goto fail;
            break;
        case K_ARRAY:
        case K_VARARRAY: {
            if (PyTuple_GET_SIZE(item) != 3)
                goto bad;
            nd->n = PyLong_AsLongLong(PyTuple_GET_ITEM(item, 1));
            long long a = PyLong_AsLongLong(PyTuple_GET_ITEM(item, 2));
            if (PyErr_Occurred())
                goto fail;
            if (check_idx(a, n, "array elem"))
                goto fail;
            nd->a = (int)a;
            break;
        }
        case K_OPT: {
            if (PyTuple_GET_SIZE(item) != 2)
                goto bad;
            long long a = PyLong_AsLongLong(PyTuple_GET_ITEM(item, 1));
            if (PyErr_Occurred())
                goto fail;
            if (check_idx(a, n, "optional elem"))
                goto fail;
            nd->a = (int)a;
            break;
        }
        case K_ENUM: {
            if (PyTuple_GET_SIZE(item) != 3)
                goto bad;
            // own the refs immediately: prog_destroy decrefs whatever
            // is stored, so never park borrowed pointers in the node
            nd->cls = PyTuple_GET_ITEM(item, 1);
            Py_INCREF(nd->cls);
            nd->map = PyTuple_GET_ITEM(item, 2);
            Py_INCREF(nd->map);
            if (!PyDict_Check(nd->map))
                goto bad;
            break;
        }
        case K_STRUCT: {
            if (PyTuple_GET_SIZE(item) != 4)
                goto bad;
            nd->cls = PyTuple_GET_ITEM(item, 1);
            Py_INCREF(nd->cls);
            nd->names = PyTuple_GET_ITEM(item, 2);
            Py_INCREF(nd->names);
            PyObject *idxs = PyTuple_GET_ITEM(item, 3);
            if (!PyType_Check(nd->cls) || !PyTuple_Check(nd->names) ||
                !PyTuple_Check(idxs))
                goto bad;
            nd->nf = (int)PyTuple_GET_SIZE(nd->names);
            if (PyTuple_GET_SIZE(idxs) != nd->nf)
                goto bad;
            nd->fidx = (int *)calloc((size_t)(nd->nf ? nd->nf : 1),
                                     sizeof(int));
            if (!nd->fidx) {
                PyErr_NoMemory();
                goto fail;
            }
            for (int j = 0; j < nd->nf; j++) {
                long long fi =
                    PyLong_AsLongLong(PyTuple_GET_ITEM(idxs, j));
                if (PyErr_Occurred())
                    goto fail;
                if (check_idx(fi, n, "struct field"))
                    goto fail;
                nd->fidx[j] = (int)fi;
            }
            break;
        }
        case K_UNION: {
            if (PyTuple_GET_SIZE(item) != 5)
                goto bad;
            nd->cls = PyTuple_GET_ITEM(item, 1);
            Py_INCREF(nd->cls);
            nd->map = PyTuple_GET_ITEM(item, 3);
            Py_INCREF(nd->map);
            long long sw = PyLong_AsLongLong(PyTuple_GET_ITEM(item, 2));
            PyObject *dflt = PyTuple_GET_ITEM(item, 4);
            if (PyErr_Occurred())
                goto fail;
            if (!PyType_Check(nd->cls) || !PyDict_Check(nd->map))
                goto bad;
            if (check_idx(sw, n, "union switch"))
                goto fail;
            nd->sw = (int)sw;
            // arm indices validated here so interpreters can trust them
            {
                PyObject *k, *val;
                Py_ssize_t pos = 0;
                while (PyDict_Next(nd->map, &pos, &k, &val)) {
                    if (!PyTuple_Check(val) || PyTuple_GET_SIZE(val) != 2)
                        goto bad;
                    long long ei =
                        PyLong_AsLongLong(PyTuple_GET_ITEM(val, 1));
                    if (PyErr_Occurred())
                        goto fail;
                    if (ei != -1 && check_idx(ei, n, "union arm"))
                        goto fail;
                }
            }
            if (PyLong_Check(dflt)) {
                nd->udefault = NULL; // "missing" marker
            } else if (dflt == Py_None) {
                Py_INCREF(Py_None);
                nd->udefault = Py_None;
            } else {
                if (!PyTuple_Check(dflt) || PyTuple_GET_SIZE(dflt) != 2)
                    goto bad;
                long long ei =
                    PyLong_AsLongLong(PyTuple_GET_ITEM(dflt, 1));
                if (PyErr_Occurred())
                    goto fail;
                if (ei != -1 && check_idx(ei, n, "union default"))
                    goto fail;
                Py_INCREF(dflt);
                nd->udefault = dflt;
            }
            break;
        }
        default:
            goto bad;
        }
        continue;
    bad:
        PyErr_Format(PyExc_ValueError, "malformed XDR program node %d", i);
    fail:
        Py_DECREF(capsule);
        return NULL;
    }
    return capsule;
}

static Prog *get_prog(PyObject *capsule, long long idx) {
    Prog *p = (Prog *)PyCapsule_GetPointer(capsule, "scxdr.prog");
    if (!p)
        return NULL;
    if (idx < 0 || idx >= p->n) {
        PyErr_Format(PyExc_IndexError, "node index %lld out of range", idx);
        return NULL;
    }
    return p;
}

static PyObject *mod_pack(PyObject *self, PyObject *const *args,
                          Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "pack(prog, idx, obj)");
        return NULL;
    }
    long long idx = PyLong_AsLongLong(args[1]);
    if (idx == -1 && PyErr_Occurred())
        return NULL;
    Prog *p = get_prog(args[0], idx);
    if (!p)
        return NULL;
    WBuf w = {NULL, 0, 0};
    if (pack_node(p, (int)idx, args[2], &w, 0)) {
        free(w.p);
        return NULL;
    }
    PyObject *out =
        PyBytes_FromStringAndSize((const char *)w.p, w.len);
    free(w.p);
    return out;
}

static PyObject *mod_unpack(PyObject *self, PyObject *const *args,
                            Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "unpack(prog, idx, data)");
        return NULL;
    }
    long long idx = PyLong_AsLongLong(args[1]);
    if (idx == -1 && PyErr_Occurred())
        return NULL;
    Prog *p = get_prog(args[0], idx);
    if (!p)
        return NULL;
    Py_buffer view;
    if (PyObject_GetBuffer(args[2], &view, PyBUF_SIMPLE))
        return NULL;
    RBuf r = {(const uint8_t *)view.buf, view.len, 0};
    PyObject *obj = unpack_node(p, (int)idx, &r, 0);
    if (obj && r.pos != r.len) {
        PyErr_Format(p->xdr_error, "%zd trailing bytes", r.len - r.pos);
        Py_DECREF(obj);
        obj = NULL;
    }
    PyBuffer_Release(&view);
    return obj;
}

static PyObject *mod_clone(PyObject *self, PyObject *const *args,
                           Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "clone(prog, idx, obj)");
        return NULL;
    }
    long long idx = PyLong_AsLongLong(args[1]);
    if (idx == -1 && PyErr_Occurred())
        return NULL;
    Prog *p = get_prog(args[0], idx);
    if (!p)
        return NULL;
    return clone_node(p, (int)idx, args[2], 0);
}

static PyMethodDef scxdr_methods[] = {
    {"build", mod_build, METH_VARARGS,
     "build(nodes, xdr_error) -> program capsule"},
    {"pack", (PyCFunction)mod_pack, METH_FASTCALL,
     "pack(prog, idx, obj) -> bytes"},
    {"unpack", (PyCFunction)mod_unpack, METH_FASTCALL,
     "unpack(prog, idx, data) -> obj"},
    {"clone", (PyCFunction)mod_clone, METH_FASTCALL,
     "clone(prog, idx, obj) -> obj"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef scxdr_module = {
    PyModuleDef_HEAD_INIT, "_scxdr",
    "Native XDR codec: schema-program interpreter", -1, scxdr_methods,
};

PyMODINIT_FUNC PyInit__scxdr(void) {
    g_empty_tuple = PyTuple_New(0);
    g_str_disc = PyUnicode_InternFromString("disc");
    g_str_arm_name = PyUnicode_InternFromString("arm_name");
    g_str_value = PyUnicode_InternFromString("value");
    if (!g_empty_tuple || !g_str_disc || !g_str_arm_name || !g_str_value)
        return NULL;
    return PyModule_Create(&scxdr_module);
}
