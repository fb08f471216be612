"""Set-up: from the process's start to the window's start (generation,
the copy to the host, segment building, the program's start, the
warm-up of every query of the mix, kernel builds where the cache is
cold)."""


def read(run):
    return run.setup_s
