"""Tokens of every step in the window over the window's wall seconds."""


def read(run):
    w = run["window"]
    return w["tokens"] / w["seconds"] if w["seconds"] > 0 else None
