"""scan.h2d_bytes_per_read: bytes staged to the card per record read
(`stats["h2d_bytes"]` over the records of the window's passes). Layer: scan
staging (`ops/kmer.scan_payload`). Moves
extract_peak_rss_gib, the cells' one end-to-end metric besides setup_s;
what it does to the pass rate shows in entry.extract_reads_per_s."""


def read(obs):
    passes = obs.get("passes") or []
    reads = sum(p["reads"] for p in passes)
    if not reads:
        return None
    return sum(p["stats"].get("h2d_bytes", 0) for p in passes) / reads
