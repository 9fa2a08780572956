"""Train any implicit-feedback model on MovieLens and report test metrics.

Unified CLI covering the reference's four per-model example scripts
(`/root/reference/examples/implicit-recsys/*_example.py` — same protocol:
early stopping on valid DCG@5, AoA test evaluation at k=5).

    python train_eval.py --model bpr --dataset ml-100k
    python train_eval.py --model wmf --weight 12 --weight_decay 3e-3
"""

import argparse

import cymf_tpu as cymf

MODELS = {
    "bpr": lambda a: cymf.BPR(
        num_components=a.num_components, learning_rate=a.learning_rate,
        weight_decay=a.weight_decay, batch_size=a.batch_size),
    "wmf": lambda a: cymf.WMF(
        num_components=a.num_components, weight_decay=a.weight_decay,
        weight=a.weight),
    "expomf": lambda a: cymf.ExpoMF(
        num_components=a.num_components, lam_y=a.lam_y,
        weight_decay=a.weight_decay),
    "relmf": lambda a: cymf.RelMF(
        num_components=a.num_components, learning_rate=a.learning_rate,
        weight_decay=a.weight_decay, clip_value=a.clip_value,
        batch_size=a.batch_size),
}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=sorted(MODELS), default="bpr")
    p.add_argument("--dataset", default="ml-100k")
    p.add_argument("--max_epochs", type=int, default=300)
    p.add_argument("--num_components", type=int, default=20)
    p.add_argument("--learning_rate", type=float, default=1e-2)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--weight", type=float, default=10.0)
    p.add_argument("--lam_y", type=float, default=1.0)
    p.add_argument("--clip_value", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--num_threads", type=int, default=8)
    p.add_argument("--unbiased_eval", action="store_true",
                   help="evaluate with the IPS (unbiased) metrics")
    p.add_argument("--save", default=None, help="save the model npz here")
    args = p.parse_args()

    ds = cymf.dataset.MovieLens(args.dataset)
    valid = cymf.AoaEvaluator(ds.valid, ds.train, metrics=["DCG"], k=5)
    eval_cls = (cymf.UnbiasedEvaluator if args.unbiased_eval
                else cymf.AoaEvaluator)
    test = eval_cls(ds.test, ds.train, k=5)

    model = MODELS[args.model](args)
    model.fit(ds.train, num_epochs=args.max_epochs,
              num_threads=args.num_threads, valid_evaluator=valid,
              early_stopping=True)
    print(test.evaluate(model.W, model.H))
    if args.save:
        model.save(args.save)
        print(f"saved to {args.save}")


if __name__ == "__main__":
    main()
