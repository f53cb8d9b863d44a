"""engine.prefilter_pass_share: scan rows sent to the card (the feed's
`stats["d2h_bytes"]` / 12, one 12-byte result a row) over the records read,
in %: what the engine's exact-match fast path and dimer prefilter let
through, soft-clip rows included. Layer: the C++ engine. Moves
extract_peak_rss_gib, the cells' one end-to-end metric besides setup_s;
what it does to the pass rate shows in entry.extract_reads_per_s."""


def read(obs):
    passes = obs.get("passes") or []
    reads = sum(p["reads"] for p in passes)
    if not reads:
        return None
    rows = sum(p["stats"].get("d2h_bytes", 0) for p in passes) / 12
    return 100.0 * rows / reads
