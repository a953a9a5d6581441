"""Set-up time: process start to the window's start (host clock)."""


def read(records):
    return records["setup_s"]
