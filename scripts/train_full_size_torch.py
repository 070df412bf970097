"""Train DeepPointMap-B at full production shapes on synthetic worlds with
the PyTorch/CUDA port, then evaluate the trained model as a whole SLAM
system around a two-lap closed loop (the port's counterpart of
scripts/train_full_size.py; the recipe lives in
deeppointmap_tpu_torch/pipeline/full_size.py).

Usage:
  python scripts/train_full_size_torch.py                   # train + eval
  python scripts/train_full_size_torch.py --measure_remat   # s/step remat
  python scripts/train_full_size_torch.py --skip_train      # eval weights
  python scripts/train_full_size_torch.py --resume log_train/full_size/checkpoints

Worlds are rendered once under --root / --eval_root and reused while their
settings hold. The trained weights go to --weights_out (default under the
ignored log_train/), with render_meta.json beside them; training logs,
steps.jsonl and checkpoints go to --out. `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deeppointmap_tpu_torch.pipeline import full_size as fs  # noqa: E402

WEIGHTS = os.path.join(REPO, "log_train/full_size/weights_final.msgpack")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root",
                    default=os.path.join(REPO, "log_train/worlds/train"))
    ap.add_argument("--eval_root",
                    default=os.path.join(REPO, "log_train/worlds/eval"))
    ap.add_argument("--out", default=os.path.join(REPO, "log_train/full_size"))
    ap.add_argument("--epochs1", type=int, default=12)
    ap.add_argument("--epochs2", type=int, default=4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--measure_remat", action="store_true")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_eval", action="store_true")
    ap.add_argument("--weights_out", default=WEIGHTS,
                    help="where the trained weights go (.msgpack); with "
                         "--skip_train, the weights to evaluate (.msgpack "
                         "or the reference's .pth)")
    ap.add_argument("--occlusion", action="store_true",
                    help="the loop-head recipe: first-return occlusion on "
                         "large worlds (extent 120, radius 42-65 m); needs "
                         "--init_weights and --epochs1 24 --epochs2 8")
    ap.add_argument("--init_weights", default="",
                    help="warm-start both stages from these weights "
                         "instead of the random init")
    ap.add_argument("--resume", default="",
                    help="resume training from a checkpoint file or the "
                         "checkpoints directory of an earlier --out")
    ap.add_argument("--sweep_reuse", action="store_true",
                    help="evaluate with tpu.sweep_reuse=True")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def train(ns) -> dict:
    """Both stages from scratch (or --init_weights / --resume); writes the
    weights and render_meta.json. -> stage wall seconds."""
    from deeppointmap_tpu_torch.pipeline.common import save_weights

    args = fs.full_train_args(ns.root, ns.out, ns.epochs1, ns.epochs2,
                              remat=ns.remat)
    trainer, ds = fs._build_trainer(args, init_weights=ns.init_weights,
                                    device=ns.device)
    if ns.resume:
        trainer.load_checkpoint(ns.resume)
        print(f"resumed from {ns.resume}: epoch {trainer.epoch}, "
              f"stage {trainer.stage}", flush=True)
    print(f"dataset: {len(ds)} frames; {trainer._steps_per_epoch()} "
          f"steps/epoch; stage epochs {trainer.stage_epochs}", flush=True)
    # each epoch's wall time, by stage
    stage_s = {1: 0.0, 2: 0.0}
    one_epoch = trainer.train_one_epoch

    def timed_epoch():
        t = time.time()
        one_epoch()
        stage_s[trainer.stage] += time.time() - t

    trainer.train_one_epoch = timed_epoch
    t0 = time.time()
    try:
        trainer.run()
    finally:
        trainer.close()
    print(f"training done in {(time.time() - t0) / 60:.1f} min", flush=True)
    os.makedirs(os.path.dirname(ns.weights_out), exist_ok=True)
    save_weights(ns.weights_out, trainer.encoder.state_dict(),
                 trainer.decoder.state_dict())
    fs.save_render_meta(ns.weights_out)
    print(f"weights -> {ns.weights_out}", flush=True)
    return dict(wall_s=time.time() - t0, stage1_s=stage_s[1],
                stage2_s=stage_s[2])


def main(argv=None) -> dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ns = build_parser().parse_args(argv)
    if ns.occlusion:
        fs.apply_occlusion_recipe()
    fs.build_training_worlds(ns.root, frames=fs.FRAMES_PER_SCENE)
    os.makedirs(ns.out, exist_ok=True)

    if ns.measure_remat:
        res = fs.measure_remat(ns.root, ns.out, device=ns.device)
        print(json.dumps(res))
        return res

    res = {}
    if not ns.skip_train:
        res["train"] = train(ns)
    if not ns.skip_eval:
        res["eval"] = fs.evaluate(ns.weights_out, ns.out, ns.eval_root,
                                  tpu_overrides={"sweep_reuse": True}
                                  if ns.sweep_reuse else None,
                                  device=ns.device)
        print(json.dumps(res["eval"]), flush=True)
    return res


if __name__ == "__main__":
    main()
