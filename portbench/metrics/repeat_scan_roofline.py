"""repeat_scan_roofline: the repeat scan kernel's share of its roofline
over the window, in %: the least time the card could take for every scan
the window made (`reference.roofline.batch_bound` on the inputs the traced
run kept of each call, summed) over the kernel's device time in the trace
(events whose name holds `repeat_scan`). Layer: the kernel. Moves
extract_peak_rss_gib, the cells' one end-to-end metric besides setup_s;
what it does to the pass rate shows in entry.extract_reads_per_s. Nothing to read without scans or kernel
events."""

from portbench.reference.roofline import batch_bound


def read(obs):
    trace = obs.get("trace")
    calls = obs.get("scan_calls") or []
    if not trace or not calls:
        return None
    kernel_s = sum(v for n, v in trace["by_name"].items() if "repeat_scan" in n)
    if kernel_s <= 0:
        return None
    bound = sum(batch_bound(x, layout, named, obs["device"],
                            obs.get("sm_hz"))["bound_s"]
                for layout, x, named in calls)
    return 100.0 * bound / kernel_s
