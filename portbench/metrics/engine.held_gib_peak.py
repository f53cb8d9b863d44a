"""engine.held_gib_peak: the most bytes the C++ engine accounted for at
once (`stats["engine"]["held_bytes_peak"]`, the largest over the window's
passes), in GiB: the held Pending records with their names, the mate table,
the produced batches, the treads and the blocks inflated ahead
(`Engine::held_bytes` in io/csrc/extract_engine.cc). Layer: the C++
engine's memory. Moves extract_peak_rss_gib. Nothing to read where a pass
lacks the engine's counters."""


def read(obs):
    passes = obs.get("passes") or []
    if not passes or any("engine" not in p["stats"] for p in passes):
        return None
    return max(p["stats"]["engine"]["held_bytes_peak"] for p in passes) / 2 ** 30
