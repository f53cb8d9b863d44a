"""feed.held_records_peak: the most records the feed loop held unfed
while the fragment-length tee filled (`stats["max_held_records"]`, the
largest over the window's passes). Layer: the feed loop. Moves
extract_peak_rss_gib."""


def read(obs):
    passes = obs.get("passes") or []
    if not passes:
        return None
    return max(p["stats"].get("max_held_records", 0) for p in passes)
