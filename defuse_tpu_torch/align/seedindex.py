"""Seed-and-extend short-read aligner — the bowtie replacement.

TPU-first design (SURVEY.md §7): exact k-mer seeds from a sorted-array
index (pigeonhole: 3 non-overlapping 16-mers cover any <=2-mismatch
alignment of a 48-50bp read), candidate verification as a batched
device-side mismatch count over gathered reference windows.  No gaps —
matching bowtie-v1's ungapped end-to-end model that the reference
pipeline relies on (``alignjob.pl:121-122``).

The index packs the reference into one int8 code array with per-sequence
offsets; seeds are 2-bit-packed uint64 keys in a sorted table queried
with vectorized searchsorted.  Index build is numpy sort-based; for
genome-scale references the build shards by chromosome.

Behavioral (not bit) parity with bowtie: alignment sets for simulated
reads match bowtie's -v 2 model; the pipeline's downstream contracts
(readid sets, concordance decisions) are what matter.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SEED_LEN = 16
MAX_MISMATCH = 2

_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _CODE[_b] = _i


def encode(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


_warned_short_reads = False


def seed_offsets(read_len: int, k: int) -> list[int]:
    """Seed start offsets for a read of ``read_len`` with seed length ``k``.

    For reads >= 3k, three disjoint seeds give the full 2-mismatch
    pigeonhole guarantee.  Shorter reads cannot fit 3 disjoint k-mers, so
    we fall back to three *staggered* seeds [0, (L-k)//2, L-k] covering
    the whole read (better sensitivity than k-strided offsets, which leave
    the suffix uncovered) — but two mismatches can still corrupt all three
    overlapping seeds, so full -v 2 sensitivity is not guaranteed; a
    one-time warning is emitted from ``candidates``/``align_batch``.
    """
    if read_len >= 3 * k:
        return [0, k, 2 * k]
    if read_len >= k:
        return sorted({0, (read_len - k) // 2, read_len - k})
    return []


def _warn_short(read_len: int, k: int) -> None:
    global _warned_short_reads
    if not _warned_short_reads and read_len < 3 * k:
        import sys
        print(f"WARNING: read length {read_len} < 3*seed_len ({3 * k}); "
              "staggered overlapping seeds in use — full 2-mismatch "
              "alignment sensitivity is not guaranteed for this library "
              "(bowtie -v 2 would find more hits). Consider a smaller "
              "seed length index for <48bp libraries.", file=sys.stderr)
        _warned_short_reads = True


@dataclasses.dataclass
class Alignment:
    ref: int        # sequence index
    pos: int        # 1-based start
    strand: int     # 0 fwd / 1 rev
    mismatches: int


class SeedIndex:
    def __init__(self, sequences: dict[str, str], seed_len: int = SEED_LEN):
        self.seed_len = seed_len
        self.prefix_table = None  # persisted form only (see load())
        self.names = list(sequences)
        self.offsets = np.zeros(len(self.names) + 1, dtype=np.int64)
        codes = []
        for i, name in enumerate(self.names):
            c = encode(sequences[name])
            codes.append(c)
            self.offsets[i + 1] = self.offsets[i] + len(c)
        self.codes = np.concatenate(codes) if codes else \
            np.zeros(0, np.int8)
        self.seq_lens = np.diff(self.offsets)

        # build sorted k-mer table over all positions (valid ACGT windows)
        n = len(self.codes)
        k = seed_len
        built = None
        if n >= k:
            from ..cluster import native
            if native.available():
                built = native.build_seed_index(self.codes, self.offsets, k)
        if built is not None:
            self.keys, self.positions = built
        elif n >= k:
            codes_u = self.codes.astype(np.uint64)  # one conversion
            m = n - k + 1
            keys = np.zeros(m, dtype=np.uint64)
            valid = np.ones(m, dtype=bool)
            for j in range(k):
                keys <<= np.uint64(2)
                keys |= codes_u[j:m + j]
                np.logical_and(valid, self.codes[j:m + j] < 4, out=valid)
            # exclude windows crossing sequence boundaries: a window is
            # intra-sequence iff its end stays before the next offset
            starts = np.arange(m, dtype=np.int64)
            seq_of_start = np.searchsorted(self.offsets, starts,
                                           side="right") - 1
            valid &= starts + k <= self.offsets[seq_of_start + 1]
            positions = starts[valid]
            keys = keys[valid]
            order = np.argsort(keys, kind="stable")
            self.keys = keys[order]
            self.positions = positions[order]
        else:
            self.keys = np.zeros(0, np.uint64)
            self.positions = np.zeros(0, np.int64)

    # -- persistence (bowtie-build equivalence: build once at create-ref,
    #    mmap-load at run; arrays stay on-disk until touched) ------------

    @staticmethod
    def _compute_ptab(keys, seed_len: int):
        """Bucket prefix table over the top min(2k, 22) key bits —
        identical content to the native BuildPrefixTable counting pass
        (bucket b spans keys[ptab[b]..ptab[b+1])).  Persisted at
        create-ref so runs mmap it instead of paying the counting pass
        per process (~1.8s at genome scale)."""
        key_bits = 2 * seed_len
        p = min(key_bits, 22)
        shift = key_bits - p
        ptab = np.zeros((1 << p) + 1, np.int64)
        if len(keys):
            counts = np.bincount((keys >> np.uint64(shift))
                                 .astype(np.int64), minlength=1 << p)
            np.cumsum(counts, out=ptab[1:])
        return ptab

    def save(self, prefix: str, source: dict | None = None) -> None:
        """Persist the index.  Every file is written to a pid-unique
        tmp name and renamed, meta last: concurrent savers cannot
        expose each other's half-written arrays, and saved_exists
        (which requires meta) can never see a loadable partial index.
        ``source`` (fasta size/mtime) is stamped into meta so
        load_or_build can detect a regenerated fasta."""
        import json
        import os

        import numpy as _np
        for name, arr in (("codes", self.codes), ("offsets", self.offsets),
                          ("keys", self.keys),
                          ("positions", self.positions),
                          ("ptab", self._compute_ptab(self.keys,
                                                      self.seed_len))):
            tmp = f"{prefix}.{name}.npy.tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                _np.save(fh, arr)
            os.replace(tmp, f"{prefix}.{name}.npy")
        meta = {"names": self.names, "seed_len": self.seed_len}
        if source:
            meta["source"] = source
        tmp = f"{prefix}.meta.json.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(meta, fh)
        os.replace(tmp, prefix + ".meta.json")

    @classmethod
    def load(cls, prefix: str) -> "SeedIndex":
        import json

        import numpy as _np
        self = cls.__new__(cls)
        with open(prefix + ".meta.json") as fh:
            meta = json.load(fh)
        self.names = meta["names"]
        self.seed_len = meta["seed_len"]
        self.codes = _np.load(prefix + ".codes.npy", mmap_mode="r")
        self.offsets = _np.load(prefix + ".offsets.npy")
        self.keys = _np.load(prefix + ".keys.npy", mmap_mode="r")
        self.positions = _np.load(prefix + ".positions.npy",
                                  mmap_mode="r")
        import os as _os
        self.prefix_table = _np.load(prefix + ".ptab.npy",
                                     mmap_mode="r") \
            if _os.path.exists(prefix + ".ptab.npy") else None
        self.seq_lens = np.diff(self.offsets)
        return self

    @classmethod
    def build_to_disk(cls, sequences: dict[str, str], prefix: str,
                      seed_len: int = SEED_LEN,
                      chunk_bp: int = 256_000_000) -> "SeedIndex":
        """Genome-scale bounded-memory index build (reference-length
        scaling, SURVEY §5): sequences are built into per-chunk sorted
        tables (peak memory ~16B x chunk_bp instead of the whole
        reference) which K-way merge straight into on-disk memmaps —
        byte-identical files to ``SeedIndex(...).save(prefix)``.
        Returns the mmap-loaded index.
        """
        import json
        import tempfile

        from ..cluster import native
        if not native.available():  # small references: plain build
            idx = cls(sequences, seed_len)
            idx.save(prefix)
            return cls.load(prefix)

        names = list(sequences)
        offsets = np.zeros(len(names) + 1, dtype=np.int64)
        for i, name in enumerate(names):
            offsets[i + 1] = offsets[i] + len(sequences[name])
        if int(offsets[-1]) >= (1 << 32):
            # the packed (key<<32|pos) chunk streams cannot represent
            # positions past 2^32 — refuse loudly rather than build a
            # silently corrupt index (same guard as the monolithic
            # native build)
            raise NotImplementedError(
                f"reference is {int(offsets[-1])} bp >= 2^32; the packed "
                "seed table cannot address it — shard the reference "
                "(e.g. per-chromosome indices) instead")
        codes_mm = np.lib.format.open_memmap(
            prefix + ".codes.npy", mode="w+", dtype=np.int8,
            shape=(int(offsets[-1]),))
        for i, name in enumerate(names):
            codes_mm[offsets[i]:offsets[i + 1]] = encode(sequences[name])
        codes_mm.flush()

        # chunk sequences into <= chunk_bp groups (>=1 sequence each)
        chunks: list[tuple[int, int]] = []
        start = 0
        for i in range(1, len(names) + 1):
            if i == len(names) or \
                    offsets[i + 1] - offsets[start] > chunk_bp:
                chunks.append((start, i))
                start = i
        chunk_files = []
        # chunks land beside the output prefix: system /tmp is often
        # RAM-backed tmpfs, which would defeat the bounded-memory build
        import os as _os
        tmpdir = tempfile.mkdtemp(
            prefix="seedidx_chunks_",
            dir=_os.path.dirname(_os.path.abspath(prefix)) or None)
        total = 0
        for ci, (i0, i1) in enumerate(chunks):
            packed = native.build_seed_chunk(
                codes_mm[offsets[i0]:offsets[i1]],
                offsets[i0:i1 + 1] - offsets[i0], seed_len,
                int(offsets[i0]))
            if packed is None:
                raise RuntimeError("native chunk build failed")
            path = f"{tmpdir}/chunk{ci}.npy"
            np.save(path, packed)
            chunk_files.append(path)
            total += len(packed)
            del packed

        keys_mm = np.lib.format.open_memmap(
            prefix + ".keys.npy", mode="w+", dtype=np.uint64,
            shape=(total,))
        pos_mm = np.lib.format.open_memmap(
            prefix + ".positions.npy", mode="w+", dtype=np.int64,
            shape=(total,))
        mapped = [np.load(p, mmap_mode="r") for p in chunk_files]
        n = native.merge_seed_chunks(mapped, keys_mm, pos_mm)
        assert n == total, (n, total)
        keys_mm.flush()
        pos_mm.flush()
        np.save(prefix + ".offsets.npy", offsets)
        np.save(prefix + ".ptab.npy",
                cls._compute_ptab(keys_mm, seed_len))
        with open(prefix + ".meta.json", "w") as fh:
            json.dump({"names": names, "seed_len": seed_len}, fh)
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)
        return cls.load(prefix)

    @classmethod
    def saved_exists(cls, prefix: str) -> bool:
        import os
        return all(os.path.exists(prefix + s) for s in
                   (".codes.npy", ".offsets.npy", ".keys.npy",
                    ".positions.npy", ".meta.json"))

    @classmethod
    def load_or_build(cls, fasta_path: str, prefix: str | None = None
                      ) -> "SeedIndex":
        """Load the saved index beside ``fasta_path`` (or at ``prefix``)
        when present and not stale; otherwise build from the fasta and
        persist it beside the fasta (bowtie-build semantics: the index
        outlives the process so later runs mmap-load instead of
        rebuilding).  Staleness: auto-persisted indices stamp the
        fasta's size/mtime into meta; a regenerated fasta at the same
        path triggers a rebuild.  create-ref-persisted indices carry no
        stamp and are trusted (explicit dataset-build contract)."""
        import json
        import os

        from ..io.fasta import FastaStore
        prefix = prefix or (str(fasta_path) + ".seedidx")

        def _source():
            st = os.stat(str(fasta_path))
            return {"size": st.st_size, "mtime_ns": st.st_mtime_ns}

        if cls.saved_exists(prefix):
            try:
                with open(prefix + ".meta.json") as fh:
                    src = json.load(fh).get("source")
            except (OSError, ValueError):
                src = None
            if src is None or src == _source():
                return cls.load(prefix)
        idx = cls(FastaStore.from_file(str(fasta_path))._seqs)
        try:
            idx.save(prefix, source=_source())
        except OSError:
            pass  # read-only dataset dir: serve the in-memory build
        return idx

    # -- queries ---------------------------------------------------------

    def _seed_keys(self, reads_codes: np.ndarray, offsets):
        """Pack seed k-mers at given offsets: (B, n_seeds) uint64 keys,
        invalid (non-ACGT) marked."""
        B, L = reads_codes.shape
        k = self.seed_len
        keys = np.zeros((B, len(offsets)), dtype=np.uint64)
        valid = np.ones((B, len(offsets)), dtype=bool)
        for si, off in enumerate(offsets):
            win = reads_codes[:, off:off + k]
            kk = np.zeros(B, dtype=np.uint64)
            for j in range(k):
                kk = (kk << np.uint64(2)) | win[:, j].astype(np.uint64)
                valid[:, si] &= win[:, j] < 4
            keys[:, si] = kk
        return keys, valid

    def candidates(self, reads_codes: np.ndarray, max_per_seed: int = 256):
        """Candidate global start positions per read (deduped), from
        3-seed pigeonhole lookup.  Returns (read_idx, global_pos) arrays.
        """
        B, L = reads_codes.shape
        k = self.seed_len
        offsets = seed_offsets(L, k)
        _warn_short(L, k)
        keys, valid = self._seed_keys(reads_codes, offsets)

        lo = np.searchsorted(self.keys, keys.ravel(), side="left")
        hi = np.searchsorted(self.keys, keys.ravel(), side="right")
        counts = np.minimum(hi - lo, max_per_seed)
        counts[~valid.ravel()] = 0

        total = int(counts.sum())
        read_idx = np.repeat(np.arange(B * len(offsets)) // len(offsets),
                             counts)
        seed_off = np.repeat(np.tile(offsets, B), counts)
        flat_starts = np.repeat(lo, counts)
        within = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts)
        table_pos = self.positions[flat_starts + within]
        cand_pos = table_pos - seed_off

        # dedupe (read, pos)
        key = read_idx.astype(np.int64) * (len(self.codes) + 64) \
            + (cand_pos + 32)
        uniq = np.unique(key)
        read_idx = (uniq // (len(self.codes) + 64)).astype(np.int64)
        cand_pos = (uniq % (len(self.codes) + 64)) - 32
        return read_idx, cand_pos

    def verify(self, reads_codes, read_lens, read_idx, cand_pos,
               max_mismatch: int = MAX_MISMATCH, verify_fn=None):
        """Count mismatches of each candidate end-to-end placement;
        keep <= max_mismatch, in-bounds, single-sequence."""
        L = reads_codes.shape[1]
        n = len(read_idx)
        if n == 0:
            return (np.zeros(0, np.int64),) * 4
        lens = read_lens[read_idx]
        seq_i = np.searchsorted(self.offsets, cand_pos, side="right") - 1
        in_bounds = (cand_pos >= 0) & \
            (cand_pos + lens <= self.offsets[np.minimum(
                seq_i + 1, len(self.offsets) - 1)]) & \
            (seq_i >= 0)
        if verify_fn is not None:
            # transfer-lean device path: ship unique reads once plus the
            # per-candidate (start, read_idx) vectors; the device gathers
            # read rows and reference windows itself
            mismatches = verify_fn(self.codes, cand_pos, reads_codes,
                                   read_idx, read_lens)
        else:
            # gather windows (clip for safety; invalid filtered after)
            gather_idx = np.clip(cand_pos[:, None] + np.arange(L)[None, :],
                                 0, len(self.codes) - 1)
            windows = self.codes[gather_idx]
            diff = (windows != reads_codes[read_idx]) \
                & (np.arange(L)[None, :] < lens[:, None])
            mismatches = diff.sum(axis=1)
        ok = in_bounds & (mismatches <= max_mismatch)
        return (read_idx[ok], cand_pos[ok], seq_i[ok],
                mismatches[ok].astype(np.int64))

    def align_batch(self, reads: list[str],
                    max_mismatch: int = MAX_MISMATCH,
                    max_alignments: int | None = None, verify_fn=None):
        """All end-to-end alignments (both strands) per read.

        Returns per-read lists of Alignment.  Reads with more than
        ``max_alignments`` hits return the sentinel ``None`` (bowtie -m
        semantics: reported as unaligned with the XM flag).
        """
        B = len(reads)
        L = max((len(r) for r in reads), default=0)
        fwd = np.full((B, L), 4, dtype=np.int8)
        rev = np.full((B, L), 4, dtype=np.int8)
        lens = np.zeros(B, dtype=np.int64)
        comp = np.array([3, 2, 1, 0, 4], dtype=np.int8)
        for i, r in enumerate(reads):
            c = encode(r)
            fwd[i, :len(c)] = c
            rev[i, :len(c)] = comp[c[::-1]]
            lens[i] = len(c)

        out: list = [[] for _ in range(B)]
        if verify_fn is None and self.seed_len <= 16 and B:
            from ..cluster import native
            if native.available():
                # native seed+verify fast path (identical hit sets/order)
                k = self.seed_len
                seed_offs = seed_offsets(L, k)
                _warn_short(L, k)
                rows = native.align_batch(
                    self, fwd.astype(np.uint8), lens.astype(np.int32),
                    seed_offs, 256, max_mismatch)
                for r, s, p, strand, m in rows.tolist():
                    out[r].append(Alignment(int(s), int(p) + 1,
                                            int(strand), int(m)))
                if max_alignments is not None:
                    for i in range(B):
                        if len(out[i]) > max_alignments:
                            out[i] = None
                return out
        for strand, codes in ((0, fwd), (1, rev)):
            ridx, cpos = self.candidates(codes)
            ridx, cpos, seq_i, mm = self.verify(codes, lens, ridx, cpos,
                                                max_mismatch, verify_fn)
            for r, p, s, m in zip(ridx, cpos, seq_i, mm):
                out[r].append(Alignment(
                    int(s), int(p - self.offsets[s] + 1), strand, int(m)))
        if max_alignments is not None:
            for i in range(B):
                if len(out[i]) > max_alignments:
                    out[i] = None
        return out
