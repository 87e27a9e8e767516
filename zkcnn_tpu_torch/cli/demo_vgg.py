"""VGG demo (reference src/main_demo_vgg.cpp; counterpart of
`zkcnn_tpu/cli/demo_vgg.py`): a built-in --model vgg11/vgg16, or
--network <file> of channel counts and M/A pool markers (reference
src/models.cpp:18-35 format), on CIFAR-sized 32x32x3 input.  It takes
the runner's options (--synthetic, --seed, --no-pcs, --cpu, --log); under
--log the witness's zero regions are checked before the proof (a
violation raises).  It runs on the first CUDA device unless --cpu is
given.

    python -m zkcnn_tpu_torch.cli.demo_vgg --synthetic --model vgg11
"""

from .runner import base_arg_parser, finish_args, run, build_model
from ..nn import models as model_zoo


def main(argv=None):
    ap = base_arg_parser("zkcnn-tpu-torch VGG demo")
    ap.add_argument("--model", default="vgg11", choices=["vgg11", "vgg16"])
    ap.add_argument("--network", help="network config file "
                    "(reference src/models.cpp:18-35 format)")
    args = finish_args(ap.parse_args(argv))
    if args.network:
        with open(args.network) as f:
            tokens = f.read().split()
        nn = model_zoo.vgg(32, 32, 3, args.pic_cnt, tokens)
        return run(nn, args, "vgg (config)", 32, 3)
    nn, psize, ksize = build_model(args.model, args)
    return run(nn, args, f"{args.model} (relu)", psize, ksize)


if __name__ == "__main__":
    main()
