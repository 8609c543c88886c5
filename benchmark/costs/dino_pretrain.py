"""Matmul FLOPs of one image of a DINO pretraining step.

The student's forward over 2 global and n local crops and the DINO head
on each crop's CLS feature, taken three times (forward and the backward's
two products a product); the teacher's forward over the 2 globals with
the head.  The head: its MLP to the bottleneck and the last layer to
out_dim prototypes.
"""
from benchmark.costs import vit_forward


def head_flops(cfg: dict) -> float:
    dims = ([cfg["embed_dim"]] + [cfg["hidden_dim"]] * (cfg["head_layers"] - 1)
            + [cfg["bottleneck_dim"], cfg["out_dim"]])
    return vit_forward.dense_flops(1, dims)


def image_flops(cfg: dict) -> float:
    g = vit_forward.vit_flops(cfg, cfg["global_crops_size"])
    loc = vit_forward.vit_flops(cfg, cfg["local_crops_size"])
    n_local = cfg["local_crops_number"]
    h = head_flops(cfg)
    student = 2 * g + n_local * loc + (2 + n_local) * h
    teacher = 2 * g + 2 * h
    return 3 * student + teacher
