"""setup_s: seconds from the harness's import to the window: loading the
port and its kernels (building them on a checkout's first run), making
the scans on the card, and the program key's eager pair and capture."""


def read(run):
    return run.setup_s
