"""device_idle.extract: the share of the traced window in which no kernel,
copy or memset ran on the card (1 - the union of device events over the
window, from torch.profiler). Layer: the device. Moves
extract_peak_rss_gib, the cells' one end-to-end metric besides setup_s;
what it does to the pass rate shows in entry.extract_reads_per_s."""


def read(obs):
    trace = obs.get("trace")
    if not trace or trace["window_s"] <= 0 or not obs.get("passes"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
