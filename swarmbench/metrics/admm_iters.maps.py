"""The stacked solve's iterations: the mean over the window's planned maps
of the mean of solver_info["iters"] over a map's groups (the last
round's)."""


def read(record: dict):
    its = [sum(i) / len(i) for b in record["batches"] for i in b["iters"]
           if i]
    return sum(its) / len(its) if its else None
