"""Share of the traced chunk's wall time in which nothing ran on the card,
in %: 1 - (union of the device's busy intervals) / (the chunk's wall),
the chunk run between two synchronisations."""


def read(run):
    prof = run["profile"]
    if not prof or prof["busy_s"] is None:
        return None
    wall = prof["t1"] - prof["t0"]
    return 100.0 * (1.0 - prof["busy_s"] / wall) if wall > 0 else None
