"""The learning oracles: counterparts of the JAX package's example scripts
(examples/toy_problem.py and examples/dino_turntable.py at the repo root),
run as `python -m unsupervised_pseuso_lidar_tpu_torch.examples.toy_problem`
and `…examples.dino_turntable`. Both train the depth net alone, with
ground-truth poses (semi_sup_pose), on the card by default (device="cpu"
to run on the CPU)."""
