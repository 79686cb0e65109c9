"""card_peak_gib: torch.cuda.max_memory_allocated over set-up and window,
read at the end of the window."""


def read(run):
    return run["card_peak_gib"]
