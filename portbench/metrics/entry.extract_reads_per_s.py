"""entry.extract_reads_per_s: the records of all the window's passes over
the whole window, in reads/s, as the traced run reads them: what a user pays
a sample in wall time. Layer: the entry (`core/extract.extract_native`, one
pass per answer). Not bounded end to end: the card's host runs the same
passes at speeds up to 1.8x apart from run to run, wider than any bound
allows. Moves extract_peak_rss_gib, the cells' one end-to-end metric besides
setup_s."""


def read(obs):
    reads, window = obs.get("reads"), obs.get("window_s")
    if not reads or not window:
        return None
    return reads / window
