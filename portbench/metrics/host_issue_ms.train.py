"""Mean of the ``gym/step`` spans (the host's time to issue one train
step) over the window's steps, in ms."""


def read(run):
    w = run["window"]
    d = [t1 - t0 for name, t0, t1, _ in run["spans"]
         if name == "gym/step" and w["t0"] <= t0 and t1 <= w["t1"]]
    return 1e3 * sum(d) / len(d) if d else None
