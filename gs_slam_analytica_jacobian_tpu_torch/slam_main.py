"""SLAM command line of the PyTorch/CUDA port (the counterpart of the
repository's ``slam.py``).

    python -m gs_slam_analytica_jacobian_tpu_torch.slam_main \\
        --config configs/synthetic/smoke.yaml [--eval] [--frames N] \\
        [--live SEC] [--viewer PORT] [--device cpu]

Runs on the GPU unless ``--device`` names another device (without a GPU
and without ``--device cpu`` it raises). There is no compile cache to
configure: the CUDA kernels build once into build/torch_kernels/.
"""

import argparse
import os
import shutil
import time

from .utils.config import load_config
from .utils.logging import Log


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--frames", type=int, default=None,
                        help="limit number of frames (debug)")
    parser.add_argument("--live", type=float, default=0.0, metavar="SEC",
                        help="stream headless-viewer PNGs of the evolving "
                             "map to <save_dir>/live every SEC seconds")
    parser.add_argument("--viewer", type=int, default=None, metavar="PORT",
                        help="serve the interactive browser viewer on "
                             "http://127.0.0.1:PORT/ (0 = auto port)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                             "kernels' plain PyTorch versions)")
    args = parser.parse_args(argv)

    config = load_config(args.config)

    if args.eval:
        Log("Running MonoGS-style evaluation mode")
        config["Results"]["save_results"] = True
        config["Results"]["use_gui"] = False
        config["Results"]["eval_rendering"] = True
        config["Results"]["use_wandb"] = False

    save_dir = None
    if config["Results"]["save_results"]:
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        path = config["Dataset"].get("dataset_path", "synthetic").rstrip("/")
        tail = os.path.join(*path.split("/")[-2:]) if "/" in path else path
        save_dir = os.path.join(config["Results"]["save_dir"], tail, stamp)
        os.makedirs(save_dir, exist_ok=True)
        shutil.copy(args.config, os.path.join(save_dir, "config.yml"))
        Log(f"saving results in {save_dir}")

    from .slam.driver import SLAM

    slam = SLAM(config, save_dir=save_dir, live_interval=args.live,
                viewer_port=args.viewer, device=args.device)
    results = slam.run(
        n_frames=args.frames,
        eval_rendering=config["Results"].get("eval_rendering", False))
    Log("Results:", results)
    return results


if __name__ == "__main__":
    main()
