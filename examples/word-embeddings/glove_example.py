"""Train GloVe word embeddings on text8 and export word2vec vectors.

Covers the reference's word-embeddings example flow
(`/root/reference/examples/word-embeddings/glove_example.py`): build the
co-occurrence matrix from text8, fit GloVe, export in word2vec text format,
optionally sanity-check by loading into gensim.

    python glove_example.py --language en --num_epochs 15
"""

import argparse


def main():
    import cymf_tpu as cymf

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--language", default="en", choices=("en", "ja"))
    p.add_argument("--min_count", type=int, default=5)
    p.add_argument("--window_size", type=int, default=10)
    p.add_argument("--num_epochs", type=int, default=15)
    p.add_argument("--num_components", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--alpha", type=float, default=0.75)
    p.add_argument("--x_max", type=float, default=10.0)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=131072)
    p.add_argument("--out", default="./vectors.txt")
    args = p.parse_args()

    print("loading text8...")
    corpus = cymf.dataset.Text8(lang=args.language,
                                min_count=args.min_count,
                                window_size=args.window_size)
    print(f"vocab: {corpus.vocab_size()}  co-occurrence nnz: {corpus.X.nnz}")

    model = cymf.GloVe(num_components=args.num_components,
                       learning_rate=args.lr, alpha=args.alpha,
                       x_max=args.x_max, batch_size=args.batch_size)
    model.fit(corpus.X, num_epochs=args.num_epochs,
              num_threads=args.threads, verbose=True)
    model.save_word2vec_format(args.out, corpus.i2w)
    print(f"wrote {args.out}")

    try:
        from gensim.models import KeyedVectors
    except ImportError:
        return
    vectors = KeyedVectors.load_word2vec_format(args.out)
    print(f"gensim load check: {len(vectors)} words")


if __name__ == "__main__":
    main()
