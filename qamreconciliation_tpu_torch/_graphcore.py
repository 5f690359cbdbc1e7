"""ctypes bindings to the native graphcore runtime (native/graphcore.cpp).

A copy of ``qamreconciliation_tpu._graphcore`` for the port: the fast
``eid,cid,vid`` CSV parser and :class:`ScalarDecoder`, the single-core
float64 flooding sum-product decoder with the reference's compiled-decoder
semantics (``iters == 0`` and the LLRs passed through for a consistent input,
``iters == max_iterations`` on failure).  It is the oracle the port's
decoders are held to and the CPU baseline of a benchmark.

The C++ source ships beside this module; the shared library is compiled with
g++ at first import and cached in ``native/_build/``, keyed by the source,
the flags and the host CPU's target options.  Import fails with ImportError when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

__all__ = ["load_edge_csv", "ScalarDecoder"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "graphcore.cpp")


_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
          "-fno-math-errno"]


def _target_options() -> bytes:
    """What ``-march=native`` resolves to on this host, as g++ reports it:
    the part of the cache key that keeps a library built for one CPU from
    being loaded on another."""
    try:
        return subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"], check=True,
            capture_output=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise ImportError(f"graphcore native build failed: {e}") from e


def _build_lib() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_target_options())
    digest = h.hexdigest()[:16]
    cache_dir = os.path.join(_HERE, "native", "_build")
    os.makedirs(cache_dir, exist_ok=True)
    lib_path = os.path.join(cache_dir, f"libgraphcore-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, "libgraphcore.so")
        cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            raise ImportError(f"graphcore native build failed: {e}") from e
        os.replace(tmp, lib_path)
    return lib_path


_lib = ctypes.CDLL(_build_lib())

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)

_lib.gc_load_edge_csv.restype = ctypes.c_int64
_lib.gc_load_edge_csv.argtypes = [
    ctypes.c_char_p,
    ctypes.POINTER(_i64p),
    ctypes.POINTER(_i64p),
    ctypes.POINTER(_i64p),
]
_lib.gc_free_i64.restype = None
_lib.gc_free_i64.argtypes = [_i64p]
_lib.gc_decoder_new.restype = ctypes.c_void_p
_lib.gc_decoder_new.argtypes = [_i64p, _i64p, ctypes.c_int64]
_lib.gc_decoder_free.restype = None
_lib.gc_decoder_free.argtypes = [ctypes.c_void_p]
for _name in ("gc_decoder_vnum", "gc_decoder_cnum", "gc_decoder_ednum"):
    fn = getattr(_lib, _name)
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p]
_lib.gc_eval_syndrome.restype = None
_lib.gc_eval_syndrome.argtypes = [ctypes.c_void_p, _u8p, _u8p]
_lib.gc_decoder_decode.restype = ctypes.c_int
_lib.gc_decoder_decode.argtypes = [
    ctypes.c_void_p, _f64p, _u8p, ctypes.c_int, _f64p,
    ctypes.POINTER(ctypes.c_int),
]


def load_edge_csv(path: str):
    """Parse an ``eid,cid,vid`` CSV -> (eid, cid, vid) int64 arrays.

    Raw rows including the totals row; the first-row convention is applied by
    the caller (utils/edgefile.py).
    """
    eid_p, cid_p, vid_p = _i64p(), _i64p(), _i64p()
    n = _lib.gc_load_edge_csv(
        path.encode(), ctypes.byref(eid_p), ctypes.byref(cid_p),
        ctypes.byref(vid_p),
    )
    if n < 0:
        raise IOError(f"graphcore failed to parse {path}")
    try:
        eid = np.ctypeslib.as_array(eid_p, shape=(n,)).copy()
        cid = np.ctypeslib.as_array(cid_p, shape=(n,)).copy()
        vid = np.ctypeslib.as_array(vid_p, shape=(n,)).copy()
    finally:
        _lib.gc_free_i64(eid_p)
        _lib.gc_free_i64(cid_p)
        _lib.gc_free_i64(vid_p)
    return eid, cid, vid


class ScalarDecoder:
    """Single-core scalar flooding BP syndrome decoder (native, float64).

    Same algorithm and semantics as the reference's compiled decoder
    (reference: qamreconciliation/decoder.pyx:391-455): one frame a call,
    exact pairwise box-plus by forward/backward scans.
    """

    def __init__(self, e_to_v, e_to_c):
        vid = np.ascontiguousarray(np.asarray(e_to_v, np.int64).reshape(-1))
        cid = np.ascontiguousarray(np.asarray(e_to_c, np.int64).reshape(-1))
        if vid.size != cid.size:
            raise ValueError("Sizes don't match")
        self._h = _lib.gc_decoder_new(
            vid.ctypes.data_as(_i64p), cid.ctypes.data_as(_i64p), vid.size
        )
        # captured at init: module globals may already be None when __del__
        # runs during interpreter shutdown
        self._free = _lib.gc_decoder_free
        self.vnum = int(_lib.gc_decoder_vnum(self._h))
        self.cnum = int(_lib.gc_decoder_cnum(self._h))
        self.ednum = int(_lib.gc_decoder_ednum(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        free = getattr(self, "_free", None)
        if h and free is not None:
            free(h)
            self._h = None

    def eval_syndrome(self, word) -> np.ndarray:
        word = np.ascontiguousarray(np.asarray(word, np.uint8).reshape(-1))
        if word.size != self.vnum:
            raise ValueError("word size mismatch")
        synd = np.zeros(self.cnum, np.uint8)
        _lib.gc_eval_syndrome(
            self._h, word.ctypes.data_as(_u8p), synd.ctypes.data_as(_u8p)
        )
        return synd

    def decode(self, lappr, synd, max_iterations: int):
        """(success: bool, iters: int, final_lappr [V] float64)."""
        lappr = np.ascontiguousarray(np.asarray(lappr, np.float64).reshape(-1))
        synd = np.ascontiguousarray(np.asarray(synd, np.uint8).reshape(-1))
        if lappr.size != self.vnum or synd.size != self.cnum:
            raise ValueError("input size mismatch")
        final = np.empty(self.vnum, np.float64)
        success = ctypes.c_int(0)
        iters = _lib.gc_decoder_decode(
            self._h,
            lappr.ctypes.data_as(_f64p),
            synd.ctypes.data_as(_u8p),
            int(max_iterations),
            final.ctypes.data_as(_f64p),
            ctypes.byref(success),
        )
        return bool(success.value), int(iters), final
