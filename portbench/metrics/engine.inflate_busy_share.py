"""engine.inflate_busy_share: the share of the inflate pool's thread time
spent inside libdeflate (`stats["engine"]["inflate_ns"]`, summed over the
window's passes, over each pass's `inflate_workers` times its wall,
summed). Layer: the C++ engine's inflate pool. Moves extract_peak_rss_gib,
the cells' one end-to-end metric besides setup_s; what it does to the pass
rate shows in entry.extract_reads_per_s. Nothing to read where a pass lacks
the engine's counters, or where no pool ran."""


def read(obs):
    passes = obs.get("passes") or []
    if not passes or any("engine" not in p["stats"] for p in passes):
        return None
    pool_s = sum(p["stats"]["engine"]["inflate_workers"] * p["wall"]
                 for p in passes)
    if pool_s <= 0:
        return None
    busy = sum(p["stats"]["engine"]["inflate_ns"] for p in passes)
    return 100.0 * busy * 1e-9 / pool_s
