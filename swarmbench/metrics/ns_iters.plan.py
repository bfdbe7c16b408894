"""The joint solve's iterations: solver_info["iters"] (the total over
the phases), the mean over the window's planned requests."""


def read(record: dict):
    its = [i[0] for b in record["batches"] for i in b["iters"] if i]
    return sum(its) / len(its) if its else None
