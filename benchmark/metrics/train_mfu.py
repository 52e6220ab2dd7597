"""The whole round's share of the card's peak, %: the clients' model FLOPs
a round (a training row at three forward passes, an evaluated row at one,
counted from the shapes by the reference model's forward_flops) times the
window's rounds, over the window and the H100 SXM's dense bf16 peak, fixed
so that a change of precision does not move the yardstick.  Read only
where the device trace shows the card worked."""

from benchmark import roofline


def read(run):
    out = run.out
    if run.trace is None or out.kind != "train":
        return None
    flops = roofline.train_round_flops(
        out.inputs["mod"].forward_flops(out.inputs["model_cfg"]),
        out.train_rows, out.eval_rows) * out.rounds
    return flops / ((out.t1 - out.t0) * roofline.BF16_FLOPS_PER_S) * 100.0
