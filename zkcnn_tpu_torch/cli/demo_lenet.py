"""LeNet demo (reference src/main_demo_lenet.cpp; counterpart of
`zkcnn_tpu/cli/demo_lenet.py`): argv-compatible `input config output
[pic_cnt]`, plus --synthetic for the missing upstream demo data,
--model to run smaller circuits, --no-pcs to leave the Hyrax
commitment out and --cpu to stay off the GPU.

    python -m zkcnn_tpu_torch.cli.demo_lenet --synthetic --pic-cnt 1
"""

from .runner import base_arg_parser, finish_args, run, build_model


def main(argv=None):
    ap = base_arg_parser("zkcnn-tpu-torch LeNet demo")
    ap.add_argument("--model", default="lenet",
                    choices=["lenet", "lenet-cifar", "ccnn"])
    args = finish_args(ap.parse_args(argv))
    nn, psize, ksize = build_model(args.model, args)
    return run(nn, args, f"{args.model} (relu)", psize, ksize)


if __name__ == "__main__":
    main()
