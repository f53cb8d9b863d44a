"""feed.unfed_batches_peak: the most batches queued unfed in the C++
engine just after a pop (`stats["unfed_batches_peak"]` of
`io/extract_native.NativeExtractor.run`), the largest over the window's
passes. Layer: the feed loop. Moves extract_peak_rss_gib: each batch
queued unfed keeps its Pending records live in the engine. None where a
pass lacks the counter."""


def read(obs):
    passes = obs.get("passes") or []
    if not passes or any("unfed_batches_peak" not in p["stats"]
                         for p in passes):
        return None
    return max(p["stats"]["unfed_batches_peak"] for p in passes)
