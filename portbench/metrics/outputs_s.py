"""The program's `outputs_s` span (every output file an inversion writes:
the models' and data's text and VTK files, the costs.txt rows, the coupling
fields, any checkpoint), mean per inversion of the window."""


def read(run):
    t = [inv.timings["outputs_s"] for inv in run.inversions if "outputs_s" in inv.timings]
    return sum(t) / len(t) if t else None
