"""feed.device_wait_share: the share of the passes' wall that the feed
loop's main thread spent waiting on a scan result (`stats["wait_s"]` of
`io/extract_native.NativeExtractor.run`, summed over the window's passes,
over the sum of their walls). Layer: the feed loop. Moves
extract_peak_rss_gib, the cells' one end-to-end metric besides setup_s;
what it does to the pass rate shows in entry.extract_reads_per_s."""


def read(obs):
    passes = obs.get("passes") or []
    wall = sum(p["wall"] for p in passes)
    if not passes or wall <= 0:
        return None
    return 100.0 * sum(p["stats"].get("wait_s", 0.0) for p in passes) / wall
