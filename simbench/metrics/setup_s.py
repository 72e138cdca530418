"""From the process's start to the first timed call ready."""


def read(rec):
    return rec["setup_s"]
