"""feed.engine_wait_share: the share of the passes' wall that the feed
loop's main thread spent blocked on the engine's producer for its next
batch (`stats["engine"]["pop_wait_ns"]` of
`io/extract_native.NativeExtractor.run`, summed over the window's passes,
over the sum of their walls). Layer: the feed loop. Moves
extract_peak_rss_gib, the cells' one end-to-end metric besides setup_s;
what it does to the pass rate shows in entry.extract_reads_per_s. Nothing
to read where a pass lacks the engine's counters."""


def read(obs):
    passes = obs.get("passes") or []
    wall = sum(p["wall"] for p in passes)
    if (not passes or wall <= 0
            or any("engine" not in p["stats"] for p in passes)):
        return None
    wait = sum(p["stats"]["engine"]["pop_wait_ns"] for p in passes)
    return 100.0 * wait * 1e-9 / wall
