"""feed.rss_start_gib: the process's resident set as a pass's feed loop
starts, before the pass holds anything (`stats["rss_start_bytes"]`, read
from /proc/self/statm by `io/extract_native.NativeExtractor.run`; the
least over the window's passes), in GiB: the baseline under the peak.
Layer: the feed loop's memory. Moves extract_peak_rss_gib. Nothing to read
where a pass lacks the reading."""


def read(obs):
    passes = obs.get("passes") or []
    if not passes or any("rss_start_bytes" not in p["stats"] for p in passes):
        return None
    return min(p["stats"]["rss_start_bytes"] for p in passes) / 2 ** 30
