"""Mean of the ``gym/data_wait`` spans (the loop waiting for its next
batch) over the window's steps, in ms."""


def read(run):
    w = run["window"]
    d = [t1 - t0 for name, t0, t1, _ in run["spans"]
         if name == "gym/data_wait" and w["t0"] <= t0 and t1 <= w["t1"]]
    return 1e3 * sum(d) / len(d) if d else None
