"""ctypes bindings for the native host library (native/defuse_host.cpp).

The native library carries the sequential host-side inner loops (exact
mate-pair EM with AS136 seeding, greedy set cover) at C++ speed; the
Python oracles remain the parity ground truth and the fallback when the
library is not built.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import pathlib
import subprocess

import numpy as np

K_MAX = 10

_LIB_PATH = pathlib.Path(__file__).resolve().parent.parent.parent / \
    "native" / "libdefuse_host.so"
_lib = None



def _default_threads() -> int:
    """Worker threads for native stages: the process's CPU *affinity*
    set, not the machine's core count — a taskset/cgroup-pinned process
    (multi-process scaling runs, containers) must not oversubscribe its
    allotment."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        return max(1, os.cpu_count() or 2)


@contextlib.contextmanager
def _build_lock():
    """An exclusive ``flock`` on a file beside the library, held while a
    process looks for the library, builds it and loads it: processes that
    start at once (``defuse cohort -w W``) build it once, and none loads a
    file that ``native/build.sh`` is still writing.  No lock where that
    file cannot be made (a read-only tree)."""
    try:
        fd = os.open(_LIB_PATH.with_name(_LIB_PATH.name + ".lock"),
                     os.O_RDWR | os.O_CREAT, 0o644)
    except OSError:
        yield
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def load_library(build_if_missing: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    from ..utils import profiling
    with profiling.process_span("process.native_load"), _build_lock():
        if not _LIB_PATH.exists() and build_if_missing:
            try:
                subprocess.run(["bash", str(_LIB_PATH.parent / "build.sh")],
                               check=True, capture_output=True)
            except Exception:
                return None
        if not _LIB_PATH.exists():
            return None
        try:
            return _configure(ctypes.CDLL(str(_LIB_PATH)))
        except AttributeError:
            # stale prebuilt .so missing a newer symbol: rebuild once and
            # retry; degrade to the Python paths rather than raising
            if not build_if_missing:
                return None
            try:
                subprocess.run(["bash", str(_LIB_PATH.parent / "build.sh")],
                               check=True, capture_output=True)
                return _configure(ctypes.CDLL(str(_LIB_PATH)))
            except Exception:
                return None


def _configure(lib):
    global _lib
    lib.dt_em_cluster.restype = ctypes.c_int
    lib.dt_em_cluster.argtypes = [
        ctypes.POINTER(ctypes.c_double)] * 3 + [
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.dt_em_cluster_batch.restype = None
    lib.dt_em_seed_batch.restype = None
    lib.dt_align_regions.restype = ctypes.c_long
    lib.dt_setcover.restype = None
    lib.dt_clustermatepairs.restype = ctypes.c_int
    lib.dt_clustermatepairs.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int]
    lib.dt_fqi_build.restype = ctypes.c_int
    lib.dt_fqi_build.argtypes = [ctypes.c_char_p] * 3
    lib.dt_split_realign.restype = ctypes.c_long
    lib.dt_split_realign.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long]
    lib.dt_collect_candidates.restype = ctypes.c_long
    lib.dt_collect_candidates.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long]
    lib.dt_reads_load.restype = ctypes.c_void_p
    lib.dt_reads_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.dt_driver_new.restype = ctypes.c_void_p
    lib.dt_driver_new.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64)]
    lib.dt_driver_n_candidates.restype = ctypes.c_long
    lib.dt_driver_n_candidates.argtypes = [ctypes.c_void_p]
    lib.dt_driver_read_matrix.restype = None
    lib.dt_driver_read_matrix.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.dt_driver_emit.restype = ctypes.c_long
    lib.dt_driver_emit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
        ctypes.c_int]
    lib.dt_driver_emit_eval.restype = ctypes.c_long
    lib.dt_driver_emit_eval.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_long, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int8), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8)]
    lib.dt_driver_free.restype = None
    lib.dt_driver_free.argtypes = [ctypes.c_void_p]
    lib.dt_build_seed_index.restype = ctypes.c_long
    lib.dt_build_seed_index.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
    lib.dt_align_batch.restype = ctypes.c_long
    lib.dt_align_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
    _lib = lib
    return lib


def available() -> bool:
    if os.environ.get("DEFUSE_NO_NATIVE"):
        return False  # force the pure Python/JAX paths (tests, dryruns)
    return load_library() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def em_cluster_batch(instances, params, n_threads: int = 0):
    """Threaded exact EM over many instances.  Returns list of cluster
    lists per instance."""
    lib = load_library()
    if n_threads <= 0:
        import os
        n_threads = _default_threads()
    n_inst = len(instances)
    offsets = np.zeros(n_inst + 1, dtype=np.int64)
    for i, (x, _y, _u) in enumerate(instances):
        offsets[i + 1] = offsets[i] + len(x)
    total = int(offsets[-1])
    X = np.zeros(total)
    Y = np.zeros(total)
    U = np.zeros(total)
    for i, (x, y, u) in enumerate(instances):
        X[offsets[i]:offsets[i + 1]] = x
        Y[offsets[i]:offsets[i + 1]] = y
        U[offsets[i]:offsets[i + 1]] = u
    member_offsets = offsets * K_MAX
    members = np.zeros(max(1, K_MAX * total), dtype=np.int32)
    sizes = np.zeros(K_MAX * n_inst, dtype=np.int32)
    counts = np.zeros(n_inst, dtype=np.int32)
    lib.dt_em_cluster_batch(
        _dptr(X), _dptr(Y), _dptr(U),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_inst,
        ctypes.c_double(params.fragment_mean),
        ctypes.c_double(params.fragment_stddev),
        ctypes.c_double(params.precision), params.min_cluster_size,
        n_threads, _iptr(members),
        member_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _iptr(sizes), _iptr(counts))
    out = []
    for i in range(n_inst):
        clusters = []
        pos = int(member_offsets[i])
        for c in range(counts[i]):
            size = int(sizes[i * K_MAX + c])
            clusters.append(members[pos:pos + size].tolist())
            pos += size
        out.append(clusters)
    return out


def em_seed_batch(instances, rows, n_threads: int = 0):
    """Threaded KKZ + AS136 one-hot seed assignments for the device
    EM's host preparation (``matepair_em_batch.prepare_batch``).

    ``instances`` is the [(x, y, u)] list; ``rows`` the expanded
    (inst_id, k, ...) row list prepare_batch built from it.  Returns
    (ic1, uniform, row_offsets): row r's n point-cluster assignments
    live at ``ic1[row_offsets[r]:row_offsets[r+1]]`` unless
    ``uniform[r]`` is set (k==1, k==n, degenerate geometry, or kmns
    ifault 1/3 — the Python ``_seed`` fallback set, identical math via
    the shared kmns twin)."""
    lib = load_library()
    if n_threads <= 0:
        n_threads = _default_threads()
    n_inst = len(instances)
    offsets = np.zeros(n_inst + 1, dtype=np.int64)
    for i, (x, _y, _u) in enumerate(instances):
        offsets[i + 1] = offsets[i] + len(x)
    total = int(offsets[-1])
    X = np.zeros(total)
    Y = np.zeros(total)
    for i, (x, y, _u) in enumerate(instances):
        X[offsets[i]:offsets[i + 1]] = x
        Y[offsets[i]:offsets[i + 1]] = y
    n_rows = len(rows)
    row_inst = np.fromiter((r[0] for r in rows), np.int32, n_rows)
    row_k = np.fromiter((r[1] for r in rows), np.int32, n_rows)
    lens = offsets[row_inst + 1] - offsets[row_inst]
    row_offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(lens, out=row_offsets[1:])
    ic1 = np.zeros(max(1, int(row_offsets[-1])), dtype=np.int32)
    uniform = np.zeros(n_rows, dtype=np.uint8)
    lib.dt_em_seed_batch(
        _dptr(X), _dptr(Y),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _iptr(row_inst), _iptr(row_k),
        row_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_long(n_rows), ctypes.c_int(n_threads), _iptr(ic1),
        uniform.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return ic1, uniform, row_offsets


def clustermatepairs(in_path: str, out_path: str, params,
                     n_threads: int = 0) -> None:
    """Full native clustering stage: compact alignment file -> cluster
    rows file.  Byte-identical to
    ``discordant.cluster_alignments`` + ``write_clusters`` (itself pinned
    to the golden build of ``tools/clustermatepairs.cpp``)."""
    lib = load_library()
    if n_threads <= 0:
        import os
        n_threads = _default_threads()
    rc = lib.dt_clustermatepairs(
        str(in_path).encode(), str(out_path).encode(),
        ctypes.c_double(params.fragment_mean),
        ctypes.c_double(params.fragment_stddev),
        ctypes.c_double(params.precision), params.min_cluster_size,
        n_threads)
    if rc != 0:
        raise RuntimeError(f"dt_clustermatepairs failed with code {rc}")


def clustermatepairs_part(in_path: str, out_path: str, sidecar_path: str,
                          params, part: int, n_parts: int,
                          n_threads: int = 0) -> None:
    """One rank's share of a distributed clustering stage: processes
    the bin pairs whose canonical (ascending-key) index ≡ ``part`` (mod
    ``n_parts``) and writes its cluster rows (locally-numbered) plus a
    sidecar with one cluster count per owned bin pair, in order.
    ``parallel.shard.merge_cluster_parts`` interleaves the rank outputs
    back into the exact single-process byte stream."""
    lib = load_library()
    if n_threads <= 0:
        n_threads = _default_threads()
    rc = lib.dt_clustermatepairs_part(
        str(in_path).encode(), str(out_path).encode(),
        str(sidecar_path).encode(),
        ctypes.c_double(params.fragment_mean),
        ctypes.c_double(params.fragment_stddev),
        ctypes.c_double(params.precision), params.min_cluster_size,
        n_threads, part, n_parts)
    if rc != 0:
        raise RuntimeError(
            f"dt_clustermatepairs_part failed with code {rc}")


def _concat_seqs(seqs):
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    buf = np.frombuffer("".join(seqs).encode(), dtype=np.uint8).copy() \
        if seqs else np.zeros(1, dtype=np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    return buf, offsets


def split_realign(ref1s, ref2s, reads, n_threads: int = 0) -> np.ndarray:
    """Full split-read realignment of candidates (DP screen + combine +
    tie-column enumeration).  Returns an (T, 5) int32 array of
    (cand_idx, i1, j2, k, score) rows in the canonical emission order
    (same contract as ``align.batch_realign.realign_candidates``)."""
    lib = load_library()
    if n_threads <= 0:
        import os
        n_threads = _default_threads()
    r1buf, r1off = _concat_seqs(ref1s)
    r2buf, r2off = _concat_seqs(ref2s)
    rdbuf, rdoff = _concat_seqs(reads)

    def _u8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def _i64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    cap = max(1024, 4 * len(reads))
    while True:
        out = np.empty((cap, 5), dtype=np.int32)
        total = lib.dt_split_realign(
            _u8(r1buf), _i64(r1off), _u8(r2buf), _i64(r2off),
            _u8(rdbuf), _i64(rdoff), len(reads), n_threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if total <= cap:
            return out[:total]
        cap = int(total)


def align_batch(index, reads_codes: np.ndarray, read_lens: np.ndarray,
                seed_offs, max_per_seed: int, max_mismatch: int,
                n_threads: int = 0) -> np.ndarray:
    """Native seed-and-extend alignment over a SeedIndex.  Returns an
    (N, 5) int32 array (read_idx, seq_i, pos0, strand, mismatches) in
    the canonical per-read order (same contract as
    ``SeedIndex.align_batch``; positions 0-based here)."""
    lib = load_library()
    if n_threads <= 0:
        import os
        n_threads = _default_threads()
    codes = np.ascontiguousarray(index.codes, dtype=np.int8)
    offs = np.ascontiguousarray(index.offsets, dtype=np.int64)
    keys = np.ascontiguousarray(index.keys, dtype=np.uint64)
    positions = np.ascontiguousarray(index.positions, dtype=np.int64)
    reads_codes = np.ascontiguousarray(reads_codes, dtype=np.uint8)
    read_lens = np.ascontiguousarray(read_lens, dtype=np.int32)
    soffs = np.ascontiguousarray(seed_offs, dtype=np.int32)

    def _p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    B, width = reads_codes.shape
    cap = max(1024, 8 * B)
    while True:
        out = np.empty((cap, 5), dtype=np.int32)
        total = lib.dt_align_batch(
            _p(codes, ctypes.c_int8), len(codes),
            _p(offs, ctypes.c_int64), len(offs) - 1,
            _p(keys, ctypes.c_uint64), _p(positions, ctypes.c_int64),
            len(keys), index.seed_len, _p(soffs, ctypes.c_int32),
            len(soffs), _p(reads_codes, ctypes.c_uint8),
            _p(read_lens, ctypes.c_int32), B, width, max_per_seed,
            max_mismatch, n_threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if total <= cap:
            return out[:total]
        cap = int(total)


def collect_candidates(sam_path: str, binned) -> np.ndarray:
    """Stream an improper SAM against a ``BinnedLocations`` and nominate
    split-read candidates (same contract as
    ``align.batch_realign.collect_candidates``).  Returns an (N, 4) int32
    array of (cluster_id, fragment, read_end, rev_comp) rows in
    nomination order."""
    lib = load_library()
    n = len(binned.ids)
    ids = np.asarray(binned.ids, dtype=np.uint32)
    starts = np.array([r[0] for r in binned.regions], dtype=np.int32)
    ends = np.array([r[1] for r in binned.regions], dtype=np.int32)
    strands = np.asarray(binned.region_strands, dtype=np.int8)
    ref_names = sorted(set(binned.region_refs))
    ref_map = {nm: i for i, nm in enumerate(ref_names)}
    refs = np.array([ref_map[nm] for nm in binned.region_refs],
                    dtype=np.int32)
    names_buf, names_off = _concat_seqs(ref_names)

    def _p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    cap = 4096
    while True:
        out = np.empty((cap, 4), dtype=np.int32)
        total = lib.dt_collect_candidates(
            str(sam_path).encode(), _p(ids, ctypes.c_uint32),
            _p(refs, ctypes.c_int32), _p(strands, ctypes.c_int8),
            _p(starts, ctypes.c_int32), _p(ends, ctypes.c_int32), n,
            names_buf.ctypes.data_as(ctypes.c_char_p),
            _p(names_off, ctypes.c_int64), len(ref_names),
            binned.bin_spacing,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if total < 0:
            raise RuntimeError(
                f"dt_collect_candidates parse error {total}")
        if total <= cap:
            return out[:total]
        cap = int(total)


def load_reads_async(fastq1: str, fastq2: str):
    """Start loading the paired fastqs in native threads; the returned
    handle is consumed (joined + freed) by :class:`RealignDriver`.
    Call early so IO/parse overlaps the clustering stage."""
    lib = load_library()
    return lib.dt_reads_load(str(fastq1).encode(), str(fastq2).encode())


def build_fqi(fastq1: str, fastq2: str, fqi_path: str) -> bool:
    """Build the ``.fqi`` offset index over fastqs that are already in
    renamed form (``@<fragment>/<end>`` headers, fragment == record
    ordinal — the ``index_paired_fastq.pl`` output contract) with a
    pure IO-bound native scan; no rewrite, no in-memory materialization.
    The scan verifies every header, so a non-renamed library can never
    get a wrong index — it returns False and the caller falls back to
    the full parse.  Written atomically (tmp + rename)."""
    lib = load_library()
    if lib is None:
        return False
    import os
    tmp = str(fqi_path) + ".tmp"
    rc = lib.dt_fqi_build(str(fastq1).encode(), str(fastq2).encode(),
                          tmp.encode())
    if rc != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    os.replace(tmp, fqi_path)
    return True


def reads_index(fastq1: str, fastq2: str, fqi_path: str | None = None):
    """Deferred .fqi-indexed read store: the realign driver preads only
    its candidate records instead of parsing the whole library (the
    full parse is ~1.5s/M pairs; candidates are typically <1% of
    fragments).  Returns a handle, or None when no ``reads.fqi`` sits
    next to the renamed fastqs and no explicit ``fqi_path`` was given
    (caller should use :func:`build_fqi` or :func:`load_reads_async`)."""
    lib = load_library()
    if lib is None:
        return None
    import pathlib

    from ..io.readindex import resolve_fastq_pair
    # original-backed stores (index-only ingest): the renamed paths are
    # virtual — resolve to the physical files + the v2 .fqi (the native
    # loader detects the header and relaxes id validation for backed
    # ends)
    paths, _backed, store_fqi = resolve_fastq_pair(fastq1, fastq2)
    fastq1, fastq2 = paths
    if fqi_path is None and store_fqi is not None:
        fqi_path = store_fqi
    p1 = pathlib.Path(fastq1)
    fqi = pathlib.Path(fqi_path) if fqi_path else p1.parent / "reads.fqi"
    if not fqi.exists():
        if fqi_path:
            return None
        name = p1.name
        if name.endswith(".1.fastq"):
            fqi = p1.parent / (name[:-8] + ".fqi")
        if not fqi.exists():
            return None
    lib.dt_reads_index.restype = ctypes.c_void_p
    handle = lib.dt_reads_index(str(fastq1).encode(),
                                str(fastq2).encode(),
                                str(fqi).encode())
    return handle or None


def reads_free(handle):
    """Free a read-store handle that will not be consumed by a
    RealignDriver (e.g. a partial group build)."""
    lib = load_library()
    if lib is not None and handle:
        lib.dt_reads_free(ctypes.c_void_p(handle))


def reads_group(handles, bases):
    """Group read store over per-rank part stores (distributed tail):
    candidate lookups dispatch to the part owning each global
    fragment-id range (``bases`` ascending, one per handle) with
    localized ids — the realign driver then preads only its candidates
    from the shard stores the per-rank frontends already indexed,
    replacing the whole-library .fqi build.  Takes ownership of the
    part handles on success.  Returns a handle or None."""
    lib = load_library()
    if lib is None or not handles or any(h is None for h in handles):
        return None
    arr = (ctypes.c_void_p * len(handles))(*handles)
    b = np.ascontiguousarray(bases, dtype=np.int64)
    fn = lib.dt_reads_group
    fn.restype = ctypes.c_void_p
    g = fn(arr, b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
           ctypes.c_int(len(handles)))
    return g or None


class RealignDriver:
    """Two-phase native realign driver.

    Phase 1 (construction) parses the fastqs + improper SAM and
    materializes candidates with reverse-complemented reads in C++.
    ``read_matrix(width)`` exposes the padded reads for the device
    screen; ``emit(out_path, survivors)`` realigns (all candidates when
    ``survivors`` is None) and writes the split rows file directly.
    Byte-identical output to the Python
    ``collect_candidates``/``realign_candidates`` chain."""

    def __init__(self, improper_sam, reads, binned, cluster_ids,
                 flank1s, flank2s):
        """``reads``: a handle from :func:`load_reads_async`, or a
        ``(fastq1, fastq2)`` tuple to load synchronously."""
        self._lib = load_library()
        if isinstance(reads, tuple):
            reads = load_reads_async(*reads)
        n = len(binned.ids)
        ids = np.asarray(binned.ids, dtype=np.uint32)
        starts = np.array([r[0] for r in binned.regions], dtype=np.int32)
        ends = np.array([r[1] for r in binned.regions], dtype=np.int32)
        strands = np.asarray(binned.region_strands, dtype=np.int8)
        ref_names = sorted(set(binned.region_refs))
        ref_map = {nm: i for i, nm in enumerate(ref_names)}
        refs = np.array([ref_map[nm] for nm in binned.region_refs],
                        dtype=np.int32)
        names_buf, names_off = _concat_seqs(ref_names)
        cids = np.asarray(cluster_ids, dtype=np.uint32)
        f1buf, f1off = _concat_seqs(flank1s)
        f2buf, f2off = _concat_seqs(flank2s)

        def _p(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        self._h = self._lib.dt_driver_new(
            str(improper_sam).encode(), ctypes.c_void_p(reads),
            _p(ids, ctypes.c_uint32),
            _p(refs, ctypes.c_int32), _p(strands, ctypes.c_int8),
            _p(starts, ctypes.c_int32), _p(ends, ctypes.c_int32), n,
            names_buf.ctypes.data_as(ctypes.c_char_p),
            _p(names_off, ctypes.c_int64), len(ref_names),
            binned.bin_spacing, _p(cids, ctypes.c_uint32), len(cids),
            f1buf.ctypes.data_as(ctypes.c_char_p),
            _p(f1off, ctypes.c_int64),
            f2buf.ctypes.data_as(ctypes.c_char_p),
            _p(f2off, ctypes.c_int64))
        if not self._h:
            raise RuntimeError("dt_driver_new failed")
        self.n_candidates = int(self._lib.dt_driver_n_candidates(self._h))

    def read_matrix(self, width: int):
        """(reads (B, width) uint8, lens (B,), flank_idx (B,))."""
        B = self.n_candidates
        reads = np.zeros((max(B, 1), width), dtype=np.uint8)
        lens = np.zeros(max(B, 1), dtype=np.int32)
        fidx = np.zeros(max(B, 1), dtype=np.int32)
        self._lib.dt_driver_read_matrix(
            self._h, reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), width)
        return reads[:B], lens[:B], fidx[:B]

    def emit(self, out_path, survivors=None, n_threads: int = 0) -> int:
        if n_threads <= 0:
            import os
            n_threads = _default_threads()
        if survivors is None:
            mask = None
        else:
            mask = np.ascontiguousarray(survivors, dtype=np.uint8)
            mask = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        total = self._lib.dt_driver_emit(
            self._h, mask, str(out_path).encode(), n_threads)
        if total < 0:
            raise RuntimeError("dt_driver_emit failed")
        return int(total)

    def emit_eval(self, tasks, cluster_ids, out_path, sorted_path,
                  seq_path, break_path, pred_path, survivors=None,
                  n_threads: int = 0):
        """Full realign tail in C++: emit + sort + per-fusion breakpoint
        vote/sequence reconstruction (``evalsplitalign`` contract) —
        byte-identical to emit() + the Python sort + ``evaluate_file``.
        Returns the split row count, or None on failure (caller falls
        back to the Python chain)."""
        if n_threads <= 0:
            import os
            n_threads = _default_threads()
        if survivors is None:
            mask = None
        else:
            mask = np.ascontiguousarray(survivors, dtype=np.uint8)
            mask = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rems, names = [], []
        starts = np.zeros(2 * len(cluster_ids), dtype=np.int64)
        lengths = np.zeros(2 * len(cluster_ids), dtype=np.int64)
        sstrand = np.zeros(2 * len(cluster_ids), dtype=np.int8)
        astrand = np.zeros(2 * len(cluster_ids), dtype=np.int8)
        for i, cid in enumerate(cluster_ids):
            t = tasks[cid]
            for e in (0, 1):
                rems.append(t.split_remainder_seq[e])
                names.append(t.align_ref_name[e])
                starts[2 * i + e] = t.split_align_seq_start[e]
                lengths[2 * i + e] = t.split_align_seq_length[e]
                sstrand[2 * i + e] = t.split_seq_strand[e]
                astrand[2 * i + e] = t.align_strand[e]
        rem_buf, rem_off = _concat_seqs(rems)
        nm_buf, nm_off = _concat_seqs(names)
        cids = np.asarray(cluster_ids, dtype=np.uint32)

        def _p(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        fn = self._lib.dt_driver_emit_eval
        fn.restype = ctypes.c_long
        total = fn(self._h, mask, str(out_path).encode(),
                   str(sorted_path).encode(), str(seq_path).encode(),
                   str(break_path).encode(), str(pred_path).encode(),
                   n_threads, _p(cids, ctypes.c_uint32),
                   ctypes.c_long(len(cids)),
                   rem_buf.ctypes.data_as(ctypes.c_char_p),
                   _p(rem_off, ctypes.c_int64),
                   _p(starts, ctypes.c_int64), _p(lengths, ctypes.c_int64),
                   _p(sstrand, ctypes.c_int8),
                   nm_buf.ctypes.data_as(ctypes.c_char_p),
                   _p(nm_off, ctypes.c_int64), _p(astrand, ctypes.c_int8))
        return int(total) if total >= 0 else None

    def close(self):
        if self._h:
            self._lib.dt_driver_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def build_seed_index(codes: np.ndarray, offsets: np.ndarray, k: int,
                     n_threads: int = 0):
    """Sorted seed table (keys uint64, positions int64) for the aligner —
    same ordering as the numpy stable-argsort build in
    ``align.seedindex.SeedIndex``.  Returns None when unsupported
    (k > 16, or references >= 2^32 bp whose positions would not fit the
    packed low-32 position field)."""
    if k > 16 or len(codes) >= (1 << 32):
        return None
    lib = load_library()
    if n_threads <= 0:
        import os
        n_threads = _default_threads()
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty(max(1, len(codes)), dtype=np.uint64)
    count = lib.dt_build_seed_index(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(codes),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets) - 1, k, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if count < 0:
        return None
    combined = out[:count]
    keys = combined >> np.uint64(32)
    positions = (combined & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return keys, positions


def set_cover(clusters: list[list[int]]) -> list[list[int]]:
    """Native greedy set cover; same contract as
    ``cluster.setcover.set_cover``."""
    lib = load_library()
    n = len(clusters)
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, c in enumerate(clusters):
        offsets[i + 1] = offsets[i] + len(c)
    members = np.zeros(max(1, int(offsets[-1])), dtype=np.int32)
    for i, c in enumerate(clusters):
        members[offsets[i]:offsets[i + 1]] = c
    keep = np.zeros(max(1, int(offsets[-1])), dtype=np.int32)
    lib.dt_setcover(
        _iptr(members),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, int(offsets[-1]), _iptr(keep))
    out = []
    for i in range(n):
        sl = slice(int(offsets[i]), int(offsets[i + 1]))
        out.append(members[sl][keep[sl] == 1].tolist())
    return out


def setcover_file(in_path, out_path, min_cluster_size) -> int | None:
    """Whole setcover stage file -> file in C++ (parse + solve +
    rewrite; byte-identical to read_cluster_fragments/set_cover/
    rewrite_clusters).  Returns kept row count or None on failure."""
    lib = load_library()
    if lib is None:
        return None
    fn = lib.dt_setcover_file
    fn.restype = ctypes.c_long
    rc = fn(ctypes.c_char_p(str(in_path).encode()),
            ctypes.c_char_p(str(out_path).encode()),
            ctypes.c_long(int(min_cluster_size)))
    return int(rc) if rc >= 0 else None


# ---------------------------------------------------------------------
# Native alignment frontend (dt_align_job): the full alignjob flow in
# C++ (align/frontend.py::align_job byte contract; alignjob.pl:216-331).
# ---------------------------------------------------------------------

def _index_group(index):
    """(codes, n, offsets, n_seqs, keys, positions, n_keys, k) ctypes
    arg tuple for one SeedIndex (or 8 nulls for None)."""
    if index is None:
        return (None, ctypes.c_long(0), None, ctypes.c_int(0), None,
                None, ctypes.c_long(0), ctypes.c_int(16))
    codes = np.ascontiguousarray(index.codes, dtype=np.int8)
    offsets = np.ascontiguousarray(index.offsets, dtype=np.int64)
    keys = np.ascontiguousarray(index.keys, dtype=np.uint64)
    positions = np.ascontiguousarray(index.positions, dtype=np.int64)
    # hold refs on the index to keep arrays alive for the call
    index._native_refs = (codes, offsets, keys, positions)
    # persisted bucket prefix table (create-ref artifact): seed the
    # process cache once so the per-process counting pass (~1.8s at
    # genome scale) is skipped; the native side copies the table
    ptab = getattr(index, "prefix_table", None)
    if ptab is not None and len(keys) \
            and not getattr(index, "_ptab_attached", False):
        lib = load_library()
        if lib is not None:
            pt = np.ascontiguousarray(ptab, dtype=np.int64)
            lib.dt_prefixtab_attach(
                keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ctypes.c_long(len(keys)), ctypes.c_int(index.seed_len),
                pt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_long(len(pt)))
            index._ptab_attached = True
    return (codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_long(len(codes)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int(len(index.names)),
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_long(len(keys)), ctypes.c_int(index.seed_len))


def _names_blob(names):
    blob = "".join(names).encode()
    off = np.zeros(len(names) + 1, dtype=np.int64)
    for i, n in enumerate(names):
        off[i + 1] = off[i] + len(n.encode())
    return blob, off


def build_align_job_tables(cdna_index, genome_index, gene_models,
                           ig_genes):
    """Flattened gene-model tables for dt_align_job (cached on the
    gene_models object keyed by the two indices)."""
    # cache holds strong references to the two indices and verifies
    # identity on hit — id() alone is unsafe (a GC'd index's address can
    # be reused, e.g. after a short-read re-index at another seed_len)
    key = tuple(sorted(ig_genes)) if ig_genes else ()
    cache = getattr(gene_models, "_native_tables", None)
    if cache is not None and cache[0] is cdna_index \
            and cache[1] is genome_index and cache[2] == key:
        return cache[3]

    chrom_intern: dict[str, int] = {}

    def cid(name):
        v = chrom_intern.get(name)
        if v is None:
            v = chrom_intern[name] = len(chrom_intern)
        return v

    n_c = len(cdna_index.names)
    c_chrom = np.zeros(n_c, np.int32)
    c_strand = np.zeros(n_c, np.int8)
    c_txlen = np.zeros(n_c, np.int32)
    c_known = np.zeros(n_c, np.uint8)
    c_is_ig = np.zeros(n_c, np.uint8)
    c_eoff = np.zeros(n_c + 1, np.int64)
    egs: list[int] = []
    ege: list[int] = []
    for i, name in enumerate(cdna_index.names):
        t = gene_models.transcripts.get(name)
        if t is not None:
            c_known[i] = 1
            c_chrom[i] = cid(t.chromosome)
            c_strand[i] = 1 if t.strand == "-" else 0
            c_txlen[i] = t.length
            for es, ee in t.exons:
                egs.append(es)
                ege.append(ee)
        else:
            c_known[i] = 1 if gene_models.is_chromosome(name) else 0
            c_chrom[i] = cid(name)
        c_eoff[i + 1] = len(egs)
        if ig_genes and name.split("|", 1)[0] in ig_genes:
            c_is_ig[i] = 1

    n_g = len(genome_index.names)
    g_chrom = np.zeros(n_g, np.int32)
    g_known = np.zeros(n_g, np.uint8)
    for i, name in enumerate(genome_index.names):
        g_chrom[i] = cid(name)
        g_known[i] = 1 if (gene_models.is_chromosome(name)
                           or gene_models.is_transcript(name)) else 0

    # gene table + binned interval index ((chrom<<32|bin) sorted keys)
    from ..annotate.gene_models import BIN_SPACING
    gene_ids = sorted(gene_models.genes)
    gene_rs = np.zeros(len(gene_ids), np.int64)
    gene_re = np.zeros(len(gene_ids), np.int64)
    bin_map: dict[int, list[int]] = {}
    for gi, gid_str in enumerate(gene_ids):
        g = gene_models.genes[gid_str]
        rs, re_ = g.region
        gene_rs[gi] = rs
        gene_re[gi] = re_
        ch = cid(g.chromosome)
        for b in range(rs // BIN_SPACING, re_ // BIN_SPACING + 1):
            bin_map.setdefault((ch << 32) | b, []).append(gi)
    gb_keys = np.array(sorted(bin_map), dtype=np.int64)
    gb_off = np.zeros(len(gb_keys) + 1, np.int64)
    genes_flat: list[int] = []
    for j, k in enumerate(gb_keys.tolist()):
        genes_flat.extend(bin_map[k])
        gb_off[j + 1] = len(genes_flat)
    gb_genes = np.asarray(genes_flat, dtype=np.int32) if genes_flat \
        else np.zeros(0, np.int32)

    c_blob, c_noff = _names_blob(cdna_index.names)
    g_blob, g_noff = _names_blob(genome_index.names)

    tables = dict(
        c_chrom=c_chrom, c_strand=c_strand, c_txlen=c_txlen,
        c_known=c_known, c_is_ig=c_is_ig, c_eoff=c_eoff,
        c_egs=np.asarray(egs, np.int64) if egs else np.zeros(0, np.int64),
        c_ege=np.asarray(ege, np.int64) if ege else np.zeros(0, np.int64),
        g_chrom=g_chrom, g_known=g_known,
        gene_rs=gene_rs, gene_re=gene_re, n_genes=len(gene_ids),
        gb_keys=gb_keys, gb_off=gb_off, gb_genes=gb_genes,
        c_blob=c_blob, c_noff=c_noff, g_blob=g_blob, g_noff=g_noff)
    gene_models._native_tables = (cdna_index, genome_index, key, tables)
    return tables


def reads_matrix(reads):
    """(B, W) uint8 char matrix + int32 lens from a list of read
    strings.  Uniform-length batches (the overwhelmingly common case)
    take a single join+frombuffer instead of a per-read Python loop."""
    B = len(reads)
    W = max((len(r) for r in reads), default=0)
    if B and all(len(r) == W for r in reads):
        arr = np.frombuffer("".join(reads).encode(),
                            dtype=np.uint8).reshape(B, W).copy()
        lens = np.full(B, W, dtype=np.int32)
        return arr, lens
    arr = np.zeros((B, max(1, W)), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        b = r.encode()
        arr[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    return arr, lens


def align_job_native(*, cdna_index, genome_index, rrna_index,
                     prefilter_index, gene_models, ig_genes, reads1,
                     reads2, improper_path, spanning_path, pair_sam_path,
                     pair_tbl_path=None, trim_len, max_insert,
                     max_paired, concord_len, max_alignments,
                     max_mismatch=2, max_per_seed=256, n_threads=0,
                     frag_base=0, append=False):
    """Full alignjob flow in C++.  Returns the read stats
    ``(n_pairs, sum_isize, sumsq_isize)`` or None when the native path
    cannot run (then the caller uses the Python path).  ``frag_base``
    offsets every emitted fragment id (data-parallel shards write
    globally-correct ids so the merge is a raw byte append —
    defuse_run.pl:387-400 semantics without the rewrite pass).  ``append``
    opens every artifact in append mode so sequential shards write
    straight into the final files (gzip members / table segments)."""
    lib = load_library()
    if lib is None:
        return None
    for ix in (cdna_index, genome_index, rrna_index, prefilter_index):
        if ix is not None and (ix.seed_len != cdna_index.seed_len
                               or ix.seed_len > 16):
            return None
    if n_threads <= 0:
        import os
        n_threads = _default_threads()

    # reads may arrive as (char_matrix, lens) tuples (native fastq
    # ingest handoff) or as lists of strings
    r1, lens1 = reads1 if isinstance(reads1, tuple) \
        else reads_matrix(reads1)
    r2, lens2 = reads2 if isinstance(reads2, tuple) \
        else reads_matrix(reads2)
    r1 = np.ascontiguousarray(r1, dtype=np.uint8)
    r2 = np.ascontiguousarray(r2, dtype=np.uint8)
    lens1 = np.ascontiguousarray(lens1, dtype=np.int32)
    lens2 = np.ascontiguousarray(lens2, dtype=np.int32)
    if len(lens1) != len(lens2):
        raise ValueError(
            f"paired fastq mismatch: {len(lens1)} end-1 reads vs "
            f"{len(lens2)} end-2 reads")
    width = max(r1.shape[1], r2.shape[1])
    if r1.shape[1] != width:
        r1 = np.ascontiguousarray(
            np.pad(r1, ((0, 0), (0, width - r1.shape[1]))))
    if r2.shape[1] != width:
        r2 = np.ascontiguousarray(
            np.pad(r2, ((0, 0), (0, width - r2.shape[1]))))
    n_frags = len(lens1)

    t = build_align_job_tables(cdna_index, genome_index, gene_models,
                               ig_genes)
    concordant = np.zeros(max(1, n_frags), np.uint8)
    blacklist = np.zeros(max(1, n_frags), np.uint8)
    stats = np.zeros(3, np.int64)

    def i64p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def i32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    fn = lib.dt_align_job
    fn.restype = ctypes.c_long
    rc = fn(
        r1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        r2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        i32p(lens1), i32p(lens2),
        ctypes.c_long(n_frags), ctypes.c_int(width),
        *_index_group(cdna_index), *_index_group(genome_index),
        *_index_group(rrna_index), *_index_group(prefilter_index),
        i32p(np.zeros(max(1, len(cdna_index.names)), np.int32)),  # c_gene
        i32p(t["c_chrom"]),
        t["c_strand"].ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        i32p(t["c_txlen"]), i64p(t["c_eoff"]), i64p(t["c_egs"]),
        i64p(t["c_ege"]),
        t["c_known"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t["c_is_ig"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        i32p(t["g_chrom"]),
        t["g_known"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        i64p(t["gene_rs"]), i64p(t["gene_re"]),
        ctypes.c_int(t["n_genes"]),
        i64p(t["gb_keys"]), i64p(t["gb_off"]), i32p(t["gb_genes"]),
        ctypes.c_long(len(t["gb_keys"])),
        ctypes.c_char_p(t["c_blob"]), i64p(t["c_noff"]),
        ctypes.c_char_p(t["g_blob"]), i64p(t["g_noff"]),
        ctypes.c_int(trim_len), ctypes.c_long(max_insert),
        ctypes.c_long(max_paired), ctypes.c_long(concord_len),
        ctypes.c_int(max_alignments), ctypes.c_int(max_mismatch),
        ctypes.c_int(max_per_seed), ctypes.c_int(n_threads),
        ctypes.c_long(frag_base), ctypes.c_int(1 if append else 0),
        ctypes.c_char_p(str(improper_path).encode()),
        ctypes.c_char_p(str(spanning_path).encode()),
        ctypes.c_char_p(str(pair_sam_path).encode()),
        ctypes.c_char_p(
            str(pair_tbl_path).encode() if pair_tbl_path else b""),
        concordant.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        blacklist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        i64p(stats))
    if rc < 0:
        return None
    return int(stats[0]), int(stats[1]), int(stats[2])


def calccov_native(sam_path, ref_names, marker_refs, marker_positions,
                   *, trim_length, anchor, span_path, pos_path,
                   min_path):
    """Native calccov sampling pass (stats/calccov.py byte contract).
    Returns sample count, or None when the native path cannot run
    (caller falls back to Python); raises ValueError on malformed
    fragment groups like the Python oracle."""
    lib = load_library()
    if lib is None:
        return None
    blob, noff = _names_blob(ref_names)
    mref = np.ascontiguousarray(marker_refs, dtype=np.int32)
    mpos = np.ascontiguousarray(marker_positions, dtype=np.int64)
    fn = lib.dt_calccov
    fn.restype = ctypes.c_long
    rc = fn(ctypes.c_char_p(str(sam_path).encode()),
            ctypes.c_char_p(blob),
            noff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int(len(ref_names)),
            mref.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_long(len(mref)), ctypes.c_long(trim_length),
            ctypes.c_long(anchor),
            ctypes.c_char_p(str(span_path).encode()),
            ctypes.c_char_p(str(pos_path).encode()),
            ctypes.c_char_p(str(min_path).encode()))
    if rc == -2:
        raise ValueError("expected 2 alignments per fragment")
    if rc < 0:
        return None
    return int(rc)


def calccov_tbl(tbl_path, ref_names, marker_refs, marker_positions, *,
                trim_length, anchor, span_path, pos_path, min_path,
                n_threads=0, merge_seed=None, bin_path=None):
    """dt_calccov over the binary pair table (threaded; byte-identical
    sample files to the SAM scan).  Returns sample count or None.

    With ``merge_seed`` set, also runs the fused covariance merge over
    the in-memory samples (bit-identical to re-reading the emitted
    files through ``cov_merge_file``) and returns
    (count, {kind: (mean, cov) | None}) — None marks the reference's
    not-enough-samples abort for that kind.

    Passing ``span_path=pos_path=min_path=None`` skips sample-file
    formatting and writing entirely (lazy-samples mode: only the fused
    merge is produced; the text artifacts are materialized on demand by
    re-running with paths — the scan is deterministic).

    ``bin_path`` writes a COVBN001 binary sample part (raw marker ids +
    %.6g-quantized values in emission order) — the distributed tail's
    parse-free input to ``cov_merge_bin``; composes with lazy mode."""
    lib = load_library()
    if lib is None:
        return None
    if n_threads <= 0:
        import os
        n_threads = _default_threads()
    blob, noff = _names_blob(ref_names)
    mref = np.ascontiguousarray(marker_refs, dtype=np.int32)
    mpos = np.ascontiguousarray(marker_positions, dtype=np.int64)
    want_merge = merge_seed is not None
    merged = np.zeros(6, dtype=np.float64)
    mcounts = np.zeros(3, dtype=np.int64)
    fn = lib.dt_calccov_tbl
    fn.restype = ctypes.c_long
    rc = fn(ctypes.c_char_p(str(tbl_path).encode()),
            ctypes.c_char_p(blob),
            noff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int(len(ref_names)),
            mref.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_long(len(mref)), ctypes.c_long(trim_length),
            ctypes.c_long(anchor),
            ctypes.c_char_p(str(span_path).encode())
            if span_path else None,
            ctypes.c_char_p(str(pos_path).encode())
            if pos_path else None,
            ctypes.c_char_p(str(min_path).encode())
            if min_path else None,
            ctypes.c_int(n_threads),
            ctypes.c_long(merge_seed if want_merge else 0),
            merged.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            if want_merge else None,
            mcounts.ctypes.data_as(ctypes.POINTER(ctypes.c_long))
            if want_merge else None,
            ctypes.c_char_p(str(bin_path).encode())
            if bin_path else None)
    if rc < 0:
        return None
    if not want_merge:
        return int(rc)
    out = {}
    for k, kind in enumerate(("span", "pos", "min")):
        out[kind] = (float(merged[2 * k]), float(merged[2 * k + 1])) \
            if mcounts[k] > 0 else None
    return int(rc), out


def pairtbl_cache_clear() -> None:
    """Release the native single-slot pair-table cache (multi-GB at
    scale; the read-stats and calccov stages share one load)."""
    lib = load_library()
    if lib is not None:
        lib.dt_pairtbl_cache_clear()


def cov_merge_bin(paths, seed=11):
    """Covariance merge over per-rank COVBN001 binary sample parts IN
    RANK ORDER (dt_cov_merge_bin): bit-identical to the single-process
    fused merge because the concatenated sample sequence equals one
    scan of the concatenated pair table.  Returns {kind: (mean, cov) |
    None} (None = the reference's not-enough-samples abort for that
    kind) or None when native is unavailable / IO fails."""
    lib = load_library()
    if lib is None:
        return None
    joined = ";".join(str(p) for p in paths)
    out = np.zeros(6, dtype=np.float64)
    counts = np.zeros(3, dtype=np.int64)
    fn = lib.dt_cov_merge_bin
    fn.restype = ctypes.c_long
    rc = fn(ctypes.c_char_p(joined.encode()), ctypes.c_long(seed),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if rc < 0:
        return None
    return {kind: (float(out[2 * k]), float(out[2 * k + 1]))
            if counts[k] > 0 else None
            for k, kind in enumerate(("span", "pos", "min"))}


COV_KINDS = ("span", "pos", "min")


def cov_merge_bin_kind(paths, kind, seed=11):
    """Merge ONE kind (0=span 1=pos 2=min) over COVBN001 parts in rank
    order — bit-identical to that entry of :func:`cov_merge_bin`, but
    reading a third of the bytes (the distributed tail fans the three
    independent kind merges across ranks).  Returns (mean, cov), None
    on native/IO failure, or raises ValueError on the count<=100
    contract."""
    lib = load_library()
    if lib is None:
        return None
    joined = ";".join(str(p) for p in paths)
    out = np.zeros(2, dtype=np.float64)
    fn = lib.dt_cov_merge_bin_kind
    fn.restype = ctypes.c_long
    rc = fn(ctypes.c_char_p(joined.encode()), ctypes.c_int(kind),
            ctypes.c_long(seed),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc == -2:
        raise ValueError("not enough concordant read samples; set "
                         "multi_exon_transcripts_stats = yes")
    if rc < 0:
        return None
    return float(out[0]), float(out[1])


def cov_merge_file(path, seed=11):
    """Native covariance-sample merge (bit-exact twin of
    stats.pvalues.cov_samples_merge over the file's rows).  Returns
    (mean, cov), None when native is unavailable/parse fails, or
    raises ValueError on the count<=100 contract."""
    lib = load_library()
    if lib is None:
        return None
    out = np.zeros(2, dtype=np.float64)
    fn = lib.dt_cov_merge
    fn.restype = ctypes.c_long
    rc = fn(ctypes.c_char_p(str(path).encode()), ctypes.c_long(seed),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc == -2:
        raise ValueError("not enough concordant read samples; set "
                         "multi_exon_transcripts_stats = yes")
    if rc < 0:
        return None
    return float(out[0]), float(out[1])


def localalign_batch(refs, seqs, match, mismatch, gap, n_threads=0):
    """Batch SimpleAligner scores (integer-exact, threaded).  refs/seqs:
    parallel lists of strings.  Returns int32 scores array or None."""
    lib = load_library()
    if lib is None:
        return None
    if n_threads <= 0:
        import os
        n_threads = _default_threads()
    r_blob, r_off = _names_blob(refs)
    s_blob, s_off = _names_blob(seqs)
    scores = np.zeros(max(1, len(refs)), dtype=np.int32)
    fn = lib.dt_localalign_batch
    fn.restype = ctypes.c_long
    fn(ctypes.c_char_p(r_blob),
       r_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       ctypes.c_char_p(s_blob),
       s_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       ctypes.c_long(len(refs)), ctypes.c_int(match),
       ctypes.c_int(mismatch), ctypes.c_int(gap),
       scores.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       ctypes.c_int(n_threads))
    return scores[:len(refs)]


def read_stats_tbl_sums(tbl_path):
    """Raw fragment-length sums for one pair table: (n, sum, sumsq,
    readlengths) — every value an exact integer carried in doubles
    (isize and isize² totals stay far below 2^53), so summing parts in
    rank order is bit-identical to one scan of the concatenated table.
    Returns None when the native library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    scalars = np.zeros(3, dtype=np.float64)
    lengths = np.zeros(256, dtype=np.int32)
    fn = lib.dt_read_stats_tbl
    fn.restype = ctypes.c_long
    rc = fn(ctypes.c_char_p(str(tbl_path).encode()),
            scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int(256))
    if rc < 0 or rc > 256:
        return None
    return (float(scalars[0]), float(scalars[1]), float(scalars[2]),
            sorted(lengths[:int(rc)].tolist()))


def read_stats_tbl(tbl_path):
    """dt_read_stats over the binary pair table — or a LIST of part
    tables, whose exact integer sums are added in list order (bit-equal
    to scanning the concatenated table).  Returns a ReadStats or None."""
    paths = ([tbl_path] if isinstance(tbl_path, (str, bytes))
             or hasattr(tbl_path, "__fspath__") else list(tbl_path))
    n = s = ss = 0.0
    lengths: set = set()
    for p in paths:
        part = read_stats_tbl_sums(p)
        if part is None:
            return None
        n += part[0]
        s += part[1]
        ss += part[2]
        lengths.update(part[3])
    from ..stats.readstats import stats_from_sums
    return stats_from_sums(n, s, ss, sorted(lengths))


def ingest_fastq(fastq1, fastq2, outdir, rename=None):
    """Native paired-fastq ingest (index_paired_fastq id contract):
    writes the .fqi + .names into ``outdir`` and returns
    ((arr1, lens1), (arr2, lens2)) read matrices, or None when the
    native library is unavailable or IO fails.

    By default the store is *index-only*: already-canonical inputs are
    hardlinked into place as ``reads.<end>.fastq`` and non-canonical
    inputs are NOT rewritten — the .fqi carries a v2 header plus
    offsets into the ORIGINAL files, recorded in ``reads.store.json``
    (see ``io.readindex.read_store``).  Retrieval synthesizes the
    canonical renamed record byte-for-byte, so every consumer sees the
    same bytes the rewrite would have produced, without the ~GB write
    (the single largest write of a run).  ``rename=True`` (or
    DEFUSE_EAGER_RENAME=1) forces the eager rewrite."""
    lib = load_library()
    if lib is None:
        return None
    import json
    import os
    import pathlib
    if rename is None:
        rename = bool(os.environ.get("DEFUSE_EAGER_RENAME"))
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    lib.dt_fastq_ingest.restype = ctypes.c_void_p
    lib.dt_fastq_matrix.restype = None
    lib.dt_fastq_free.restype = None
    dims = np.zeros(5, dtype=np.int64)
    handle = lib.dt_fastq_ingest(
        ctypes.c_char_p(str(fastq1).encode()),
        ctypes.c_char_p(str(fastq2).encode()),
        ctypes.c_char_p(str(out / "reads.1.fastq").encode()),
        ctypes.c_char_p(str(out / "reads.2.fastq").encode()),
        ctypes.c_char_p(str(out / "reads.fqi").encode()),
        ctypes.c_char_p(str(out / "reads.names").encode()),
        ctypes.c_int(0 if rename else 1),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if not handle:
        return None
    store_path = out / "reads.store.json"
    backed = [bool(dims[3]), bool(dims[4])]
    if not any(backed) and store_path.exists():
        store_path.unlink()  # stale store from a previous backed run
    try:
        n1, n2, width = (int(dims[0]), int(dims[1]), int(dims[2]))
        width = max(1, width)
        mats = []
        for end, n in ((0, n1), (1, n2)):
            arr = np.zeros((n, width), dtype=np.uint8)
            lens = np.zeros(max(1, n), dtype=np.int32)
            lib.dt_fastq_matrix(
                ctypes.c_void_p(handle), ctypes.c_int(end),
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_long(width))
            mats.append((arr, lens[:n]))
    finally:
        lib.dt_fastq_free(ctypes.c_void_p(handle))
    if any(backed):
        # committed only AFTER dt_fastq_free joined the deferred .fqi
        # writer thread (ADVICE r4: a sidecar visible while the index is
        # still being written let a crash leave a valid-looking store
        # over a truncated .fqi, silently resolving high fragment ids to
        # None).  n_fragments lets read_store cross-check the .fqi size.
        originals = [str(fastq1), str(fastq2)]
        stamps = []
        for p in originals:
            st = os.stat(p)
            stamps.append({"size": st.st_size,
                           "mtime_ns": st.st_mtime_ns})
        tmp = str(store_path) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"fastq": originals, "backed": backed,
                       "stamp": stamps,
                       "n_fragments": max(int(dims[0]), int(dims[1]))},
                      fh)
        os.replace(tmp, store_path)
    return tuple(mats)


def merge_seed_chunks(chunk_arrays, out_keys, out_positions):
    """K-way merge of sorted packed (key<<32|pos) chunk tables into the
    split keys/positions output arrays (typically np.memmap) — the
    genome-scale bounded-memory index build."""
    lib = load_library()
    n = len(chunk_arrays)
    ptrs = (ctypes.POINTER(ctypes.c_uint64) * n)(*[
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        for a in chunk_arrays])
    sizes = np.array([len(a) for a in chunk_arrays], dtype=np.int64)
    fn = lib.dt_merge_seed_chunks
    fn.restype = ctypes.c_long
    return int(fn(
        ptrs, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(n),
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))))


def build_seed_chunk(codes_slice, offsets_rebased, k, global_base,
                     n_threads: int = 0):
    """Sorted packed (key<<32|global_pos) table for one chunk of
    sequences (positions rebased to the whole-reference coordinate)."""
    lib = load_library()
    if n_threads <= 0:
        import os
        n_threads = _default_threads()
    codes_slice = np.ascontiguousarray(codes_slice, dtype=np.int8)
    offsets_rebased = np.ascontiguousarray(offsets_rebased,
                                           dtype=np.int64)
    out = np.empty(max(1, len(codes_slice)), dtype=np.uint64)
    count = lib.dt_build_seed_index(
        codes_slice.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        len(codes_slice),
        offsets_rebased.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets_rebased) - 1, k, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if count < 0:
        return None
    packed = out[:count].copy()
    if global_base:
        # global position fits the low-32 field (2^32 guard upstream)
        packed += np.uint64(global_base)
    return packed


def read_stats_native(sam_path):
    """Native read-stats pass (stats/readstats.py contract).  Returns a
    ReadStats or None (fallback); raises ValueError on pairing errors
    like the Python oracle."""
    lib = load_library()
    if lib is None:
        return None
    scalars = np.zeros(3, dtype=np.float64)
    lengths = np.zeros(256, dtype=np.int32)
    fn = lib.dt_read_stats
    fn.restype = ctypes.c_long
    rc = fn(ctypes.c_char_p(str(sam_path).encode()),
            scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int(256))
    if rc == -2:
        raise ValueError("SAM mate pairing error")
    if rc < 0 or rc > 256:
        # >256 distinct read lengths would truncate the set (and
        # misreport readlength_max): fall back to the Python oracle
        return None
    from ..stats.readstats import ReadStats
    n = int(scalars[0])
    rl = sorted(lengths[:int(rc)].tolist())
    if n > 0:
        mean = scalars[1] / n
        var = scalars[2] / n - mean ** 2
        std = var ** 0.5
        return ReadStats(n, mean, std, rl[0] if rl else 0,
                         rl[-1] if rl else 0, tuple(rl))
    return ReadStats(0, 0.0, 0.0, rl[0] if rl else 0,
                     rl[-1] if rl else 0, tuple(rl))
