"""Configuration system honoring the reference's ``config.txt`` contract.

Key=value lines with ``$(var)`` interpolation, injected
``dataset_directory``/``source_directory``, list keys by numeric suffix
and comma-split lists (``scripts/configdata.pm``).  All reference
threshold keys keep their meanings (``scripts/config.txt:66-112``); new
TPU-specific keys are namespaced ``tpu_*``.
"""

from __future__ import annotations

import pathlib
import re

_LINE_RE = re.compile(r"^\s*([^=\s]+)\s*=\s*(.*)$")
_INTERP_RE = re.compile(r"\$\(([^)]+)\)")

DEFAULTS = {
    # filtering / clustering thresholds (reference defaults)
    "max_insert_size": "500",
    "dna_concordant_length": "2000",
    "discord_read_trim": "50",
    "calculate_extra_annotations": "no",
    # pair-SAM text checkpoint: "lazy" derives it on demand from the
    # binary pair table (native frontend); "eager" writes it up front
    "pair_sam_checkpoint": "lazy",
    "denovo_assembly": "no",
    "clustering_precision": "0.95",
    "span_count_threshold": "5",
    "percent_identity_threshold": "0.90",
    "split_min_anchor": "4",
    "splice_bias": "10",
    "probability_threshold": "0.50",
    "multi_exon_transcripts_stats": "no",
    "covariance_sampling_density": "0.01",
    "max_paired_alignments": "10",
    "reads_per_job": "1000000",
    "mt_chromosome": "MT",
    "num_blat_sequences": "10000",
    # TPU runtime
    "tpu_batch_reads": "512",
    "tpu_em_dtype": "auto",
    "tpu_mesh_data": "1",
    "tpu_mesh_inst": "1",
}


class Config:
    def __init__(self, values: dict[str, str]):
        self._values = values

    @classmethod
    def read(cls, path: str, dataset_directory: str = "",
             source_directory: str = "") -> "Config":
        values = dict(DEFAULTS)
        values["dataset_directory"] = dataset_directory
        values["source_directory"] = source_directory
        with open(path) as fh:
            for line in fh:
                m = _LINE_RE.match(line.rstrip("\n"))
                if not m:
                    continue
                values[m.group(1)] = m.group(2)
        # $(var) interpolation, recursive like configdata.pm:43-56
        for key in list(values):
            guard = 0
            while True:
                m = _INTERP_RE.search(values[key])
                if not m:
                    break
                other = m.group(1)
                if other not in values:
                    raise KeyError(
                        f"no value for {other} in config file {path}")
                values[key] = values[key].replace(
                    f"$({other})", values[other])
                guard += 1
                if guard > 100:
                    raise ValueError(f"interpolation loop at {key}")
        return cls(values)

    @classmethod
    def defaults(cls, **overrides) -> "Config":
        values = dict(DEFAULTS)
        values.update({k: str(v) for k, v in overrides.items()})
        return cls(values)

    def with_value(self, key: str, value) -> "Config":
        """A copy with one value overridden (CLI flags layered over a
        config file, e.g. ``--report-margin``)."""
        values = dict(self._values)
        values[key] = str(value)
        return type(self)(values)

    def has_value(self, key: str) -> bool:
        return key in self._values

    def get_value(self, key: str) -> str:
        if key not in self._values:
            raise KeyError(f"no value for {key} in config")
        return self._values[key]

    def get_float(self, key: str) -> float:
        return float(self.get_value(key))

    def get_int(self, key: str) -> int:
        return int(self.get_value(key))

    def get_bool(self, key: str) -> bool:
        return self.get_value(key).strip().lower() == "yes"

    def get_list(self, key: str) -> list[str]:
        """Comma-split list (``configdata.pm:83-91``)."""
        return [v for v in self.get_value(key).split(",") if v != ""]

    def get_indexed(self, prefix: str) -> list[str]:
        """Values of keys ``prefix1, prefix2, ...``
        (``configdata.pm:93-109``)."""
        out = []
        i = 1
        while f"{prefix}{i}" in self._values:
            out.append(self._values[f"{prefix}{i}"])
            i += 1
        return out
