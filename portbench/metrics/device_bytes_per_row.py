"""What the card pays to hold the data: its allocated bytes after the
warm-up (every block the mix reads staged, and whatever else the program
keeps on the card between queries) less those before the program was
started, over the rows the cell holds. Read from the CUDA allocator by
the benchmark, not from the program's own counters; the device pool's
resident and evicted bytes are printed beside it."""


def read(run):
    if run.held_bytes is None or not run.held_rows:
        return None
    return run.held_bytes / run.held_rows
