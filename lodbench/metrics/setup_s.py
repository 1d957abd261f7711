"""setup_s: seconds from the process's start to the window's (imports, the
card, the kernel library, the scan made and written, the warm-up)."""


def read(rec):
    return rec["setup_s"]
