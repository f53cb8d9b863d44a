"""engine.inflate_mib_per_s: one inflate worker's speed, the bytes
libdeflate produced over the time inside it
(`stats["engine"]["inflate_out_bytes"]` over `["inflate_ns"]`, each summed
over the window's passes), in MiB/s: a yardstick of the host's speed taken
inside the work itself. Layer: the C++ engine's inflate pool. Moves
extract_peak_rss_gib, the cells' one end-to-end metric besides setup_s;
what it does to the pass rate shows in entry.extract_reads_per_s. Nothing
to read where a pass lacks the engine's counters."""


def read(obs):
    passes = obs.get("passes") or []
    if not passes or any("engine" not in p["stats"] for p in passes):
        return None
    ns = sum(p["stats"]["engine"]["inflate_ns"] for p in passes)
    if ns <= 0:
        return None
    out = sum(p["stats"]["engine"]["inflate_out_bytes"] for p in passes)
    return out / 2 ** 20 / (ns * 1e-9)
