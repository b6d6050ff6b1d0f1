"""Host-or-device decisions of the three offloadable stages, at any link.

Counterpart of ``defuse_tpu/pipeline/routing.py``, with its names, its
cost models and its return dicts, and with the rates of the card: each
decision weighs the link's round trips and upload and a measured device
rate against a measured host rate.

* the split-read DP **screen** (``pipeline/discover.py``, which routes by
  ``screen_decision`` under ``DEFUSE_DEVICE_SCREEN=auto``): the device side
  is what the port's ``_screen`` pays (the read matrix, the padding, the
  operands, the copy and the kernel), the host side what the native
  realign pays for the candidates the screen would remove;
* candidate **verify** in the aligner frontend
  (``ops/verify_batch.verify_cost_model``, which ``DeviceVerifier`` consults
  on every call under ``DEFUSE_DEVICE_VERIFY=auto``);
* the bin-pair **EM**: the native C++ EM against the batched EM on the card
  (``cluster/matepair_em_batch``).  As in the reference, this decision only
  feeds the table; the live rule is ``cluster_alignments``'s (native when
  built, else the batched EM with ``use_device``, else the oracle).

``routing_table`` evaluates the three at any link points; ``LINK_POINTS``
holds the card's own link (``core.devices.link_profile`` without
overrides).  Every constant below was measured on an NVIDIA H100 80GB HBM3
at a 700.00 W power limit by ``chip_smoke.py`` phase 14, from the runs of
the phases it names.
"""

from __future__ import annotations

from ..core.devices import LINK_BW_MBPS, LINK_RTT_MS

# link operating points (MB/s, ms)
LINK_POINTS = {
    # the card's host link: pageable host-to-device copies and the round
    # trip of an empty launch (core/devices.py)
    "h100": {"bw_MBps": LINK_BW_MBPS, "rtt_ms": LINK_RTT_MS},
}

# the screen (phase 14 on the bench dataset, 46,953 candidates, from the
# forced and the unscreened discover runs alternated five times each):
# candidates a second of the whole screen:* time less its link terms, and
# candidates a second a core that the native realign takes to emit what the
# screen removes (the median realign:emit difference over the candidates
# removed and over cluster.native._default_threads())
# (screen:* 6.1 ms, 88.5% of it on the host, so the whole is fitted; the
# emit 18.1 ms shorter for 29,548 candidates removed, on 8 threads)
SCREEN_DEVICE_READS_S = 8.91e6
SCREEN_HOST_READS_S_PER_CORE = 204e3
# the EM (phase 12 on the bench dataset's 381 bin pairs, 3,806 rows, the
# batched EM in float64 as run_batch runs it, its second run, each slab
# segment one launch of em_rows_kernel; the native EM the median of five
# runs in phase 14):
EM_NATIVE_ROWS_S = 55.1e3         # native.em_cluster_batch, 0.069 s
EM_DEVICE_COMPUTE_ROWS_S = 50.7e3  # rows over the run's 0.105 s less its
                                   # upload (0.030 s)
EM_UPLOAD_BYTES_PER_ROW = 6203    # EM_RUN_STATS["up_MB"] (23.6) over the rows
EM_SLAB_ROWS = 89                 # rows over EM_RUN_STATS["slabs"] (43)


def screen_decision(n_candidates: int, read_pad_len: int, link: dict,
                    ncpu: int = 4) -> dict:
    """The discover split-realign screen's model: 3 round trips + the
    reads matrix's upload + the screen at its rate, against the native
    realign of the candidates on ``ncpu`` cores."""
    bw = link["bw_MBps"] * 1e6
    rtt = link["rtt_ms"] / 1e3
    t_dev = (3 * rtt + 2 * n_candidates * read_pad_len / bw
             + n_candidates / SCREEN_DEVICE_READS_S)
    t_host = n_candidates / (SCREEN_HOST_READS_S_PER_CORE * ncpu)
    return {"t_dev_s": round(t_dev, 4), "t_host_s": round(t_host, 4),
            "choice": "device" if t_dev < t_host else "host"}


def verify_decision(n_candidates: int, n_reads: int, read_len: int,
                    link: dict) -> dict:
    """The frontend verify stage's model
    (``ops/verify_batch.verify_cost_model``)."""
    from ..ops.verify_batch import verify_cost_model
    t_dev, t_host = verify_cost_model(n_candidates, n_reads, read_len,
                                      link)
    return {"t_dev_s": round(t_dev, 4), "t_host_s": round(t_host, 4),
            "choice": "device" if t_dev < t_host else "host"}


def em_decision(n_rows: int, link: dict) -> dict:
    """Bin-pair EM: native C++ against the batched EM on the card.  The
    device side pays two round trips, a fraction of one a slab dispatch,
    the groups' upload and the run at its measured rate."""
    bw = link["bw_MBps"] * 1e6
    rtt = link["rtt_ms"] / 1e3
    n_slabs = max(1, -(-n_rows // EM_SLAB_ROWS))
    t_dev = (2 * rtt + 0.3 * rtt * n_slabs
             + n_rows * EM_UPLOAD_BYTES_PER_ROW / bw
             + n_rows / EM_DEVICE_COMPUTE_ROWS_S)
    t_host = n_rows / EM_NATIVE_ROWS_S
    return {"t_dev_s": round(t_dev, 4), "t_host_s": round(t_host, 4),
            "choice": "device" if t_dev < t_host else "host"}


def routing_table(screen_candidates: int = 46953, read_pad_len: int = 64,
                  verify_candidates: int = 55537,
                  verify_reads: int = 92800, verify_read_len: int = 50,
                  em_rows: int = 3806, links: dict | None = None,
                  ncpu: int | None = None) -> dict:
    """Decision table for every offloadable stage at every link point.
    Defaults are the bench dataset's shapes (``chip_smoke.py`` phases 5, 7
    and 12): the screen's candidates and padded read length, the
    frontend's largest verify call, the EM's rows.  ``ncpu`` defaults to
    the native library's threads (``cluster.native._default_threads``)."""
    if ncpu is None:
        from ..cluster.native import _default_threads
        ncpu = _default_threads()
    table = {}
    for name, link in (links or LINK_POINTS).items():
        table[name] = {
            "link": link,
            "screen": screen_decision(screen_candidates, read_pad_len,
                                      link, ncpu),
            "verify": verify_decision(verify_candidates, verify_reads,
                                      verify_read_len, link),
            "em": em_decision(em_rows, link),
        }
    return table
