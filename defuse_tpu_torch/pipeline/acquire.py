"""Dataset acquisition — the download half of ``defuse_create_ref.pl``.

Builds the download manifest the reference constructs inline
(``defuse_create_ref.pl:134-237``): per-chromosome Ensembl DNA fastas,
the Ensembl GTF, UCSC rmsk / est.fa / intronEst tables and the NCBI
unigene clusters — then fetches them with a resumable, checksum-recording
fetcher and performs the derivations of ``defuse_create_ref.pl:561-629``:
fasta description cleanup, genome concatenation, rmsk → repeats.regions
conversion, and the round-robin EST fasta split (``divide_fasta.pl``).

Base URLs are config-overridable (``download_base_ensembl`` /
``download_base_ucsc`` / ``download_base_ncbi``) so mirrors — or local
``file://`` trees in tests — substitute for the public FTP sites.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import pathlib
import time
import urllib.error
import urllib.request

DEFAULT_ENSEMBL = "ftp://ftp.ensembl.org/pub"
DEFAULT_UCSC = "ftp://hgdownload.cse.ucsc.edu/goldenPath"
DEFAULT_NCBI = "ftp://ftp.ncbi.nlm.nih.gov/repository/UniGene"


def build_manifest(config) -> list[dict]:
    """Download manifest: list of {name, url, dest, gunzip} entries.

    URL construction mirrors ``defuse_create_ref.pl``: the Ensembl
    chromosome fasta naming changed at release 76; hg18 repeats and EST
    alignments are per-chromosome files with MT renamed to M.
    """
    ens = config.get_value("download_base_ensembl") \
        if config.has_value("download_base_ensembl") else DEFAULT_ENSEMBL
    ucsc = config.get_value("download_base_ucsc") \
        if config.has_value("download_base_ucsc") else DEFAULT_UCSC
    ncbi = config.get_value("download_base_ncbi") \
        if config.has_value("download_base_ncbi") else DEFAULT_NCBI

    ev = int(config.get_value("ensembl_version"))
    gver = config.get_value("ensembl_genome_version")
    uver = config.get_value("ucsc_genome_version")
    organism = config.get_value("ensembl_organism") \
        if config.has_value("ensembl_organism") else "homo_sapiens"
    organism_cap = organism[:1].upper() + organism[1:]
    chromosomes = config.get_list("chromosomes")
    mt = config.get_value("mt_chromosome") \
        if config.has_value("mt_chromosome") else "MT"
    chromosome_prefix = config.get_value("chromosome_prefix")

    entries: list[dict] = []
    for c in chromosomes:
        if ev < 76:
            url = (f"{ens}/release-{ev}/fasta/{organism}/dna/"
                   f"{organism_cap}.{gver}.{ev}.dna.chromosome.{c}.fa.gz")
        else:
            url = (f"{ens}/release-{ev}/fasta/{organism}/dna/"
                   f"{organism_cap}.{gver}.dna.chromosome.{c}.fa.gz")
        entries.append({"name": f"chromosome.{c}", "url": url,
                        "dest": f"{chromosome_prefix}.{c}.fa",
                        "gunzip": True, "clean_descriptions": True})

    entries.append({
        "name": "gene_models",
        "url": (f"{ens}/release-{ev}/gtf/{organism}/"
                f"{organism_cap}.{gver}.{ev}.gtf.gz"),
        "dest": config.get_value("gene_models"), "gunzip": True})

    repeats = config.get_value("repeats_filename")
    if uver == "hg18":
        for c in chromosomes:
            uc = "M" if c == mt else c
            entries.append({
                "name": f"rmsk.{uc}",
                "url": f"{ucsc}/hg18/database/chr{uc}_rmsk.txt.gz",
                "dest": f"{repeats}.{uc}.part.txt", "gunzip": True,
                "concat_into": repeats})
    else:
        entries.append({"name": "rmsk",
                        "url": f"{ucsc}/{uver}/database/rmsk.txt.gz",
                        "dest": repeats, "gunzip": True})

    entries.append({"name": "est_fasta",
                    "url": f"{ucsc}/{uver}/bigZips/est.fa.gz",
                    "dest": config.get_value("est_fasta"),
                    "gunzip": True})

    est_aln = config.get_value("est_alignments")
    if uver == "hg18":
        for c in chromosomes:
            uc = "M" if c == mt else c
            entries.append({
                "name": f"intronEst.{uc}",
                "url": f"{ucsc}/hg18/database/chr{uc}_intronEst.txt.gz",
                "dest": f"{est_aln}.{uc}.part.txt", "gunzip": True,
                "concat_into": est_aln})
    else:
        entries.append({
            "name": "intronEst",
            "url": f"{ucsc}/{uver}/database/intronEst.txt.gz",
            "dest": est_aln, "gunzip": True})

    entries.append({
        "name": "unigene",
        "url": f"{ncbi}/{organism_cap}/Hs.seq.uniq.gz",
        "dest": config.get_value("unigene_fasta"), "gunzip": True})
    return entries


def fetch(url: str, dest: str, *, gunzip: bool = False, retries: int = 3,
          expected_sha256: str | None = None, _chunk: int = 1 << 20
          ) -> dict:
    """Resumable fetch of ``url`` into ``dest``.

    The compressed payload streams into ``dest + '.part'``; on
    interruption the next call resumes with an HTTP Range request
    (servers that ignore Range restart transparently).  The payload
    sha256 is computed over the complete compressed stream and returned
    (and verified when ``expected_sha256`` is given).  ``gunzip``
    decompresses into ``dest`` after the transfer completes; writes are
    atomic (tmp + rename).
    """
    dest_p = pathlib.Path(dest)
    dest_p.parent.mkdir(parents=True, exist_ok=True)
    part = dest_p.with_name(dest_p.name + ".part")

    last_err: Exception | None = None
    for attempt in range(retries):
        try:
            offset = part.stat().st_size if part.exists() else 0
            req = urllib.request.Request(url)
            if offset and url.startswith(("http://", "https://")):
                req.add_header("Range", f"bytes={offset}-")
            with urllib.request.urlopen(req) as resp:
                status = getattr(resp, "status", 200)
                if offset and status != 206:
                    # server ignored the Range header: restart
                    offset = 0
                mode = "ab" if offset else "wb"
                with open(part, mode) as out:
                    while True:
                        chunk = resp.read(_chunk)
                        if not chunk:
                            break
                        out.write(chunk)
            break
        except (urllib.error.URLError, OSError) as e:
            last_err = e
            if attempt == retries - 1:
                raise
            time.sleep(min(2 ** attempt, 10))
    else:
        raise last_err  # pragma: no cover

    sha = hashlib.sha256()
    with open(part, "rb") as fh:
        for chunk in iter(lambda: fh.read(_chunk), b""):
            sha.update(chunk)
    digest = sha.hexdigest()
    if expected_sha256 is not None and digest != expected_sha256:
        part.unlink()
        raise ValueError(f"checksum mismatch for {url}: got {digest}, "
                         f"expected {expected_sha256}")

    tmp = dest_p.with_name(dest_p.name + ".tmp")
    if gunzip:
        with gzip.open(part, "rb") as fin, open(tmp, "wb") as fout:
            while True:
                chunk = fin.read(_chunk)
                if not chunk:
                    break
                fout.write(chunk)
    else:
        part.replace(tmp)
    tmp.replace(dest_p)
    if part.exists():
        part.unlink()
    return {"url": url, "dest": str(dest_p), "sha256": digest,
            "bytes": dest_p.stat().st_size}


def remove_fasta_descriptions(path: str) -> None:
    """Keep only the first token of each fasta header
    (``remove_fasta_description.pl``), in place."""
    p = pathlib.Path(path)
    tmp = p.with_name(p.name + ".nodesc")
    with open(p) as fin, open(tmp, "w") as fout:
        for line in fin:
            if line.startswith(">"):
                line = line.split()[0] + "\n"
            fout.write(line)
    tmp.replace(p)


def convert_rmsk(rmsk_path: str, repeats_regions: str) -> None:
    """UCSC rmsk table → repeats.regions (chrom, start+1, end, type) —
    exact port of the conversion loop ``defuse_create_ref.pl:605-629``
    (the chr prefix is stripped, start shifts to 1-based)."""
    out_p = pathlib.Path(repeats_regions)
    tmp = out_p.with_name(out_p.name + ".tmp")
    with open(rmsk_path) as fin, open(tmp, "w") as fout:
        for line in fin:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            chrom = f[5]
            start = int(f[6]) + 1
            end = f[7]
            rtype = f[11]
            if chrom.startswith("chr"):
                chrom = chrom[3:]
            fout.write(f"{chrom}\t{start}\t{end}\t{rtype}\n")
    tmp.replace(out_p)


def split_fasta_round_robin(fasta_path: str, out_paths: list[str]) -> None:
    """``divide_fasta.pl``: sequences dealt round-robin to the outputs,
    one record each in turn."""
    outs = [open(p + ".tmp", "w") for p in out_paths]
    try:
        idx = 0
        name = None
        seq: list[str] = []

        def emit():
            nonlocal idx
            if name is not None:
                outs[idx].write(f">{name}\n{''.join(seq)}\n")
                idx = (idx + 1) % len(outs)

        with open(fasta_path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    emit()
                    name = line[1:]
                    seq = []
                else:
                    seq.append(line)
            emit()
    finally:
        for fh in outs:
            fh.close()
    for p in out_paths:
        pathlib.Path(p + ".tmp").replace(p)


def acquire_dataset(config, dataset_directory: str) -> dict:
    """Fetch every manifest entry that is missing, then derive the
    downstream tables (genome concat, repeats.regions, EST splits).
    Records per-file checksums in ``download.manifest.json``; rerunning
    skips complete files (resume-at-file granularity on top of the
    fetcher's resume-at-byte)."""
    dataset = pathlib.Path(dataset_directory)
    dataset.mkdir(parents=True, exist_ok=True)
    manifest_path = dataset / "download.manifest.json"
    recorded: dict[str, dict] = {}
    if manifest_path.exists():
        recorded = json.loads(manifest_path.read_text())

    entries = build_manifest(config)
    concat_groups: dict[str, list[str]] = {}
    for e in entries:
        dest = pathlib.Path(e["dest"])
        if e.get("concat_into"):
            concat_groups.setdefault(e["concat_into"], []).append(
                str(dest))
        if dest.exists() and e["name"] in recorded:
            continue
        expected = None
        if config.has_value(f"sha256_{e['name']}"):
            expected = config.get_value(f"sha256_{e['name']}")
        info = fetch(e["url"], str(dest), gunzip=e.get("gunzip", False),
                     expected_sha256=expected)
        if e.get("clean_descriptions"):
            remove_fasta_descriptions(str(dest))
        recorded[e["name"]] = info
        # atomic: a kill mid-write must not corrupt the resume manifest
        mtmp = manifest_path.with_name(manifest_path.name + ".tmp")
        mtmp.write_text(json.dumps(recorded, indent=1))
        mtmp.replace(manifest_path)

    # per-chromosome concat targets (hg18 rmsk / intronEst)
    for target, parts in concat_groups.items():
        tp = pathlib.Path(target)
        if not tp.exists():
            tmp = tp.with_name(tp.name + ".tmp")
            with open(tmp, "wb") as out:
                for p in parts:
                    out.write(pathlib.Path(p).read_bytes())
            tmp.replace(tp)

    # genome fasta = concatenated chromosome fastas in config order
    genome_fasta = pathlib.Path(config.get_value("genome_fasta"))
    if not genome_fasta.exists():
        prefix = config.get_value("chromosome_prefix")
        tmp = genome_fasta.with_name(genome_fasta.name + ".tmp")
        with open(tmp, "wb") as out:
            for c in config.get_list("chromosomes"):
                out.write(pathlib.Path(f"{prefix}.{c}.fa").read_bytes())
        tmp.replace(genome_fasta)

    # rmsk -> repeats.regions
    repeats_regions = config.get_value("repeats_regions")
    if not pathlib.Path(repeats_regions).exists():
        convert_rmsk(config.get_value("repeats_filename"),
                     repeats_regions)

    # EST round-robin split (divide_fasta.pl)
    est_splits = config.get_indexed("est_split_fasta")
    if est_splits and not all(pathlib.Path(p).exists()
                              for p in est_splits):
        split_fasta_round_robin(config.get_value("est_fasta"),
                                est_splits)

    return {"manifest": str(manifest_path),
            "genome_fasta": str(genome_fasta),
            "repeats_regions": repeats_regions,
            "est_splits": est_splits}
