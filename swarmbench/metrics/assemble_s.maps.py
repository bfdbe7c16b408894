"""QP assembly: solver_info["assemble_s"] summed over a batch's stacked
solves, the mean over the window's batches."""


def read(record: dict):
    per = [sum(a for a, _ in b["stacks"]) for b in record["batches"]
           if b["stacks"]]
    return sum(per) / len(per) if per else None
