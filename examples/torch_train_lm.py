"""End-to-end training driver for the PyTorch port: train a small LM on the
synthetic Markov stream with ``repro_torch``'s Trainer (AdamW,
checkpointing, auto-resume).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_lm.py --size 100m \
        --steps 300 --ckpt /tmp/ckpt_100m     # the ~100M-param config

On CUDA (the default) the steps run the Hopper kernels under their
autograd Functions; ``--device cpu`` runs the plain versions. The
reference's driver builds a one-device mesh; one device with no mesh is
the same step here (the port's 1 x 1 mesh is bitwise the meshless
Trainer). Interrupting and re-running with the same ``--ckpt`` resumes
from the newest checkpoint.
"""
import argparse
import logging

from repro_torch.data.synthetic import DataConfig
from repro_torch.models.common import ModelConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

SIZES = {
    # ~1M params: CI-fast demonstration
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                 d_ff=512, vocab=512),
    # ~25M params
    "25m": dict(n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
                d_ff=2048, vocab=2048),
    # ~100M params (the deliverable-scale config)
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                 d_ff=3072, vocab=32000),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny", choices=sorted(SIZES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    cfg = ModelConfig(arch_id=f"train_lm_{args.size}", family="dense",
                      **SIZES[args.size])
    trainer = Trainer(
        cfg,
        opt_cfg=OptimizerConfig(lr=args.lr, warmup_steps=20,
                                total_steps=args.steps),
        tcfg=TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt,
                           ckpt_every=50, log_every=10),
        dcfg=DataConfig(batch=args.batch, seq=args.seq),
        device=args.device)
    last = trainer.run()
    first = trainer.metrics_history[0]
    print(f"\nfirst logged loss: {first['loss']:.4f}  ->  "
          f"final loss: {last['loss']:.4f}")


if __name__ == "__main__":
    main()
