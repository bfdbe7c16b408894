"""The joint solve: solver_info["solve_s"] of the plan (the phased
knot-state ADMM and the read-back of its solution), the mean over the
window's requests."""


def read(record: dict):
    v = [t["solve_s"] for b in record["batches"]
         for t in b.get("times", ()) if t and t.get("solve_s") is not None]
    return sum(v) / len(v) if v else None
