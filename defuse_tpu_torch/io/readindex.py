"""O(1) read lookup via the binary ``.fqi`` offset index.

v1 is the layout the reference's ``ReadIndex`` consumes
(``tools/ReadIndex.cpp:67-129``): for fragment ids 0..N-1, two packed
little-endian int64s per fragment — the byte offset of the fragment's
fastq record in the end-1 and end-2 files.

v2 (original-backed stores) prepends a 16-byte header — magic
``DFQI2\\0\\0\\0`` + uint64 per-end backed flags — and offsets for
backed ends point into the ORIGINAL (un-renamed) fastq named by the
``<prefix>.store.json`` sidecar.  Retrieval synthesizes the canonical
renamed record (``@<fragment>/<end>`` header, original sequence, ``+``,
``'I'`` quality string) byte-for-byte, so consumers are agnostic to
whether the renamed file was ever written.  The store sidecar stamps
the originals' size/mtime; a modified original fails resolution loudly
instead of serving wrong reads.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct

V2_MAGIC = b"DFQI2\x00\x00\x00"


def read_store(prefix: str):
    """Resolve the physical backing of a read-store ``prefix``.

    Returns ``(paths, backed, fqi_path)`` where ``paths[end]`` is the
    file to pread for end 0/1 (the renamed/hardlinked file, or the
    original for backed ends), ``backed[end]`` says whether records
    there carry arbitrary headers (synthesize on retrieval), and
    ``fqi_path`` is the offset index (None if absent).  Raises
    ``FileNotFoundError``/``ValueError`` when a backed store's
    originals are missing or were modified after indexing.
    """
    prefix = str(prefix)
    paths = [prefix + ".1.fastq", prefix + ".2.fastq"]
    backed = [False, False]
    store_path = pathlib.Path(prefix + ".store.json")
    if store_path.exists():
        store = json.loads(store_path.read_text())
        for end in range(2):
            if store["backed"][end]:
                orig = store["fastq"][end]
                try:
                    st = os.stat(orig)
                except OSError as e:
                    raise FileNotFoundError(
                        f"original-backed read store {prefix} needs "
                        f"{orig}: {e}") from e
                stamp = store["stamp"][end]
                if (st.st_size != stamp["size"]
                        or st.st_mtime_ns != stamp["mtime_ns"]):
                    raise ValueError(
                        f"{orig} changed since the read store at "
                        f"{prefix} was indexed (size/mtime mismatch); "
                        "re-run the ingest")
                paths[end] = orig
                backed[end] = True
    fqi = prefix + ".fqi"
    if not os.path.exists(fqi):
        if any(backed):
            raise FileNotFoundError(
                f"original-backed read store {prefix} lost its .fqi")
        fqi = None
    elif store_path.exists() and "n_fragments" in store:
        # cross-check the index size against the sidecar's fragment
        # count (ADVICE r4): a truncated .fqi from an interrupted ingest
        # must fail loudly here, not resolve high fragment ids to None
        want = (16 if any(backed) else 0) + store["n_fragments"] * 16
        got = os.path.getsize(fqi)
        if got != want:
            raise ValueError(
                f"{fqi} is {got} bytes but the store sidecar says "
                f"{store['n_fragments']} fragments ({want} bytes) — "
                "truncated/partial index; re-run the ingest")
    return paths, backed, fqi


def resolve_fastq_pair(fastq1: str, fastq2: str):
    """``read_store`` keyed by the (possibly virtual) renamed-fastq pair
    — callers hold ``<prefix>.1.fastq``/``<prefix>.2.fastq`` paths from
    the frontend.  Falls back to the literal paths (no store, no fqi)
    for plain files with no sidecars."""
    f1 = str(fastq1)
    if f1.endswith(".1.fastq"):
        prefix = f1[: -len(".1.fastq")]
        if (os.path.exists(prefix + ".store.json")
                or os.path.exists(prefix + ".fqi")):
            return read_store(prefix)
    return [str(fastq1), str(fastq2)], [False, False], None


class ReadIndex:
    RECORD = struct.Struct("<qq")

    def __init__(self, prefix: str):
        prefix = str(prefix)
        paths, self._backed, fqi = read_store(prefix)
        if fqi is None:
            raise FileNotFoundError(prefix + ".fqi")
        self._fqi = open(fqi, "rb")
        head = self._fqi.read(len(V2_MAGIC))
        self._base = 16 if head == V2_MAGIC else 0
        self._fastq = [open(paths[0], "rb"), open(paths[1], "rb")]

    def close(self):
        self._fqi.close()
        for fh in self._fastq:
            fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def get(self, fragment: int, end: int) -> str:
        """Read sequence for (fragment, end 0/1); '' when out of range."""
        rec = self.get_record(fragment, end)
        return rec[1] if rec else ""

    def get_record(self, fragment: int, end: int):
        """Full fastq record (header, sequence, comment, quality) for
        (fragment, end 0/1) with trailing newlines stripped, or None
        when out of range — the seek protocol of
        ``get_fusion_fastq.pl:output_reads_to_fastq``.  Backed ends
        synthesize the canonical renamed record, byte-identical to what
        the eager rewrite would have stored."""
        self._fqi.seek(self._base + fragment * self.RECORD.size)
        raw = self._fqi.read(self.RECORD.size)
        if len(raw) < self.RECORD.size:
            return None
        offset = self.RECORD.unpack(raw)[end]
        if offset < 0:
            return None  # backed-store miss marker for an absent end
        fh = self._fastq[end]
        fh.seek(offset)
        header = fh.readline()
        if not header.startswith(b"@"):
            return None
        if self._backed[end]:
            seq = fh.readline().rstrip(b"\n").decode()
            return (f"@{fragment}/{end + 1}", seq, "+", "I" * len(seq))
        # defensive: offset 0 is also the miss marker for absent ends
        if int(header[1:].rsplit(b"/", 1)[0]) != fragment:
            return None
        return tuple(
            [header.rstrip(b"\n").decode()]
            + [fh.readline().rstrip(b"\n").decode() for _ in range(3)])

    @staticmethod
    def build(fastq1: str, fastq2: str, fqi_path: str) -> None:
        """Write the index for integer-renamed paired fastqs."""
        offsets = [{}, {}]
        n = 0
        for end, path in ((0, fastq1), (1, fastq2)):
            pos = 0
            with open(path, "rb") as fh:
                while True:
                    start = pos
                    header = fh.readline()
                    if not header:
                        break
                    pos += len(header)
                    for _ in range(3):
                        pos += len(fh.readline())
                    frag = int(header[1:].rsplit(b"/", 1)[0])
                    offsets[end][frag] = start
                    n = max(n, frag + 1)
        with open(fqi_path, "wb") as out:
            for frag in range(n):
                out.write(ReadIndex.RECORD.pack(
                    offsets[0].get(frag, 0), offsets[1].get(frag, 0)))


def exists(prefix: str) -> bool:
    p = pathlib.Path(str(prefix) + ".fqi")
    return p.exists()


def store_present(prefix: str) -> bool:
    """True when a read store answers for ``prefix`` — either the
    renamed fastqs on disk or an original-backed store (sidecar +
    .fqi).  The cached-run detection for flows that re-enter a kept
    output directory."""
    prefix = str(prefix)
    if os.path.exists(prefix + ".1.fastq"):
        return True
    return (os.path.exists(prefix + ".store.json")
            and os.path.exists(prefix + ".fqi"))


def iter_renamed_fastq(path):
    """Yield ``(read_id, seq)`` for every record of a (possibly
    virtual) renamed fastq path, where ``read_id`` packs the fragment
    ordinal with the end bit (``fragment | (end << 31)``) — the key
    scheme of ``SplitRealigner.add_reads_fastq``.  For original-backed
    stores the renamed file does not exist on disk; records stream from
    the original in order (ordinal == fragment id, by the ingest's
    construction)."""
    p = str(path)
    end = None
    for e, suf in ((0, ".1.fastq"), (1, ".2.fastq")):
        if p.endswith(suf):
            end, prefix = e, p[: -len(suf)]
            break
    if end is not None and os.path.exists(prefix + ".store.json"):
        paths, backed, _fqi = read_store(prefix)
        if backed[end]:
            with open(paths[end], buffering=1 << 20) as fh:
                frag = 0
                while True:
                    header = fh.readline()
                    if not header:
                        return
                    seq = fh.readline().rstrip("\n")
                    fh.readline()
                    fh.readline()
                    yield frag | (end << 31), seq
                    frag += 1
        p = paths[end]
    with open(p, buffering=1 << 20) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            seq = fh.readline().rstrip("\n")
            fh.readline()
            fh.readline()
            name = header[1:].rstrip("\n")
            fragment, rec_end = name.rsplit("/", 1)
            yield int(fragment) | ((0 if rec_end == "1" else 1) << 31), seq
