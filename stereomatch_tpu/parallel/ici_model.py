"""Analytic interconnect traffic / scaling-efficiency model — and its
consumers.

``select_sgm_mode`` picks the row-sharded SGM strategy from (tiles,
geometry) predictions, and the exact mode's serial carry chain is hidden
behind the batch axis (parallel/sharded.py::_handoff_sweep's frame
pipeline), which this model prices via ``batch``.

Scaling efficiency is *predicted* from first principles: count the bytes
each config moves between devices per frame (halos, carries, reduction
combines — formulas read off the shard_map bodies in parallel/), compare
them with the per-device memory bytes of the compute itself, and model
efficiency as mem_time / (mem_time + link_time + serialization).  The
rates are the device's published figures (utils/devices.py — on the
H100, NVLink at 450 GB/s each way and HBM at 3.35 TB/s); a device with no
published figures is an error, so callers on other devices pass their
rates explicitly.  ``hop_latency_us`` is a modelling assumption for one
collective hop, not a measured figure.
"""

from __future__ import annotations


def ici_traffic_model(*, height, width, disp, tiles, link_gbps, hbm_gbps,
                      kernel=7, overlap=48, cvf_radius=8, itemsize=4,
                      hop_latency_us=5.0, batch=1):
    """Per-config interconnect traffic and predicted scaling efficiency.

    ``batch`` is the local frames per chip: the exact SGM hand-off runs
    as a (frame, tile) wavefront, so its serialization cost amortizes as
    (tiles + batch - 1) / batch stages per frame instead of ``tiles``
    (sharded.py::_handoff_sweep).  Returns a list of per-config dicts;
    quoted in docs/architecture.md and printed by dryrun_multichip.
    """
    T = tiles
    B = max(batch, 1)
    vol = height * width * disp * itemsize          # one full volume
    hl = height // T
    rows = []

    def add(name, link_bytes, serial_stages, compute_scale=1.0, note=""):
        # Per-chip compute: the full pipeline moves ~16 volume-sized HBM
        # transfers (cost ~5, SGM ~10, WTA ~1); each chip owns 1/T of it.
        hbm_bytes = 16 * vol * compute_scale / T
        hbm_ms = hbm_bytes / 1e9 / hbm_gbps * 1e3
        link_ms = (link_bytes / 1e9 / link_gbps * 1e3
                   + serial_stages * hop_latency_us / 1e3)
        rows.append({
            "config": name, "tiles": T,
            "link_bytes_per_frame": int(link_bytes),
            "link_vs_volume": round(link_bytes / vol, 4),
            "serial_stages": serial_stages,
            "hbm_bytes_per_chip": int(hbm_bytes),
            "link_ms": round(link_ms, 4), "hbm_ms": round(hbm_ms, 4),
            "predicted_efficiency": round(hbm_ms / (hbm_ms + link_ms), 3),
            "note": note,
        })

    b = T - 1                                        # tile boundaries
    img_halo = 2 * 2 * kernel * width * 4 * b        # 2 images x 2 dirs

    # Row-sharded SGM, exact carry hand-off (parallel/sharded.py): a
    # 3-family [3, W, D] carry per boundary, forward + reverse, f32 over
    # the links regardless of storage dtype.  The hand-off serializes
    # 2 * (T + B - 1) wavefront stages over B frames: per frame, the
    # serialization amortizes with the batch.
    add("sgm_exact",
        img_halo + 2 * b * 3 * width * disp * 4,
        serial_stages=max(1, round(2 * (T + B - 1) / B)),
        note=f"carry [3,W,D] fwd+rev per boundary; (frame,tile) "
             f"wavefront over batch={B}")

    # Row-sharded SGM, overlap mode: image halos of (overlap + kernel)
    # rows, no carries, no serialization; each tile computes 2*overlap
    # redundant rows.
    add("sgm_overlap",
        2 * 2 * (overlap + kernel) * width * 4 * b,
        serial_stages=1,
        compute_scale=(hl + 2 * overlap) / hl,
        note=f"redundant compute x{(hl + 2 * overlap) / hl:.2f}")

    # 2-D tiling (tiled2d.py): row halos + column halos; the LR volume
    # re-index ships a D-column volume slab along the W axis.
    tw = max(int(T ** 0.5), 1)
    th = max(T // tw, 1)
    add("tiled2d_lr_volume",
        2 * 2 * (overlap + kernel) * width * 4 * (th - 1)
        + 2 * 2 * (overlap + kernel) * (height // th) * 4 * (tw - 1)
        + (disp * (height // th) * disp * itemsize) * (tw - 1),
        serial_stages=2,
        note="row+col halos + D-column LR volume slab per W boundary")

    # Disparity-block WTA (sharded.py make_disp_sharded_wta): per-pixel
    # (min, argmin) ring combine over the D shards.
    add("disp_sharded_wta",
        2 * b / max(T, 1) * height * width * 8 * T,
        serial_stages=1,
        note="per-pixel (val,idx) all-reduce")

    # CVF row-sharded (sharded.py): 2*radius volume+guide halo rows per
    # boundary, both directions.
    add("cvf",
        2 * 2 * cvf_radius * width * (disp * itemsize + 4) * b,
        serial_stages=1,
        note="volume+guide halos of 2r rows")

    # FGS (sharded.py): cross-rank Thomas hand-off — per iteration,
    # forward c'/d' rows and backward u0 row per boundary, 3 iterations
    # x row+column solves.
    add("fgs",
        3 * 2 * (2 + 1) * width * 4 * b,
        serial_stages=3 * 2 * T,
        note="tridiagonal c',d' fwd + u0 bwd per boundary, 3 iters")

    # Temporal band tracking (temporal_sharded.py): census-code halo rows
    # for the band window + the poor-fraction psum (scalar pair).
    add("temporal_band",
        2 * 2 * ((5 // 2) + 1) * width * 4 * b + 8 * T,
        serial_stages=1,
        note="code halos + scalar psum")

    return rows


def select_exact_schedule(*, tiles, batch, vmap_eff=0.585):
    """Wavefront vs naive hand-off schedule for EXACT row-sharded SGM.

    Both schedules produce bit-identical volumes; they differ in how the
    serial carry chain is filled (parallel/sharded.py::_handoff_sweep vs
    _handoff_sweep_naive):

    * naive: ``tiles`` stages, every stage computing ALL local frames
      vmapped — tiles*batch chunk computations, but each vmapped chunk
      costs only ~``vmap_eff`` of a standalone one (the scan's per-step
      overhead amortizes across the batch lanes);
    * wavefront: ``tiles + batch - 1`` stages of ONE frame each.

    Cost model (chunk units): naive = tiles * batch * vmap_eff,
    wavefront = tiles + batch - 1.  ``vmap_eff`` = 0.585 is fitted from
    a CPU-mesh A/B (batch 2: naive 27.44 vs wavefront 29.23 ms; batch 4:
    wavefront 1.33x faster) — not yet re-measured on GPUs.  At batch 1 the two schedules are literally the
    same computation; naive is returned for its simpler loop.
    """
    T, B = max(tiles, 1), max(batch, 1)
    naive_cost = T * B * vmap_eff
    wave_cost = T + B - 1
    schedule = "wavefront" if wave_cost < naive_cost and B > 1 else "naive"
    return schedule, {
        "naive_chunk_units": round(naive_cost, 2),
        "wavefront_chunk_units": wave_cost,
        "tiles": T, "batch": B, "picked": schedule,
    }


def select_sgm_mode(*, height, width, disp, tiles, batch=1, overlap=64,
                    link_gbps=None, hbm_gbps=None, device_kind=None):
    """Pick the row-sharded SGM strategy from the model's predictions.

    Rates default to the published figures of ``device_kind`` (default:
    JAX's first device) from utils/devices.py, which raises for a device
    it has no figures for.

    Returns (mode, info): mode is "exact" or "overlap"; info carries both
    configs' predicted efficiencies for logging (dryrun_multichip prints
    it).  Policy: EXACT is preferred whenever its predicted efficiency is
    within 5% of overlap's — it is bit-exact against the single chip
    while overlap is a warm-up approximation — so overlap is selected
    only when the model says the serial chain genuinely dominates (few
    frames per chip, many tiles).  The frame-pipelined hand-off
    (batch > 1) usually tips the balance back to exact.
    """
    if link_gbps is None or hbm_gbps is None:
        from ..utils.devices import device_spec
        spec = device_spec(device_kind)
        link_gbps = spec.link_bytes_per_s / 1e9 if link_gbps is None \
            else link_gbps
        hbm_gbps = spec.hbm_bytes_per_s / 1e9 if hbm_gbps is None \
            else hbm_gbps
    rows = {r["config"]: r for r in ici_traffic_model(
        height=height, width=width, disp=disp, tiles=tiles, batch=batch,
        overlap=overlap, link_gbps=link_gbps, hbm_gbps=hbm_gbps)}
    exact = rows["sgm_exact"]
    over = rows["sgm_overlap"]
    mode = ("exact" if exact["predicted_efficiency"]
            >= 0.95 * over["predicted_efficiency"] else "overlap")
    return mode, {
        "exact_efficiency": exact["predicted_efficiency"],
        "overlap_efficiency": over["predicted_efficiency"],
        "batch": batch, "tiles": tiles,
        "picked": mode,
    }
