"""wrong_after_share: read bases wrong after correction, left or made,
over the bases wrong before it, against the error-free reads; the worst
distinct answer of the window."""

from portbench import judge


def reading(run):
    answers = judge.distinct(run.outputs, lambda o: id(o["corrected"]))
    return max((judge.wrong_after_share(run, o["corrected"])
                for o in answers), default=None)
