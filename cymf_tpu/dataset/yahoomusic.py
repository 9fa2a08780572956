"""Yahoo! R3 loader (rebuild of `/root/reference/cymf/dataset/yahoomusic.py`).

Protocol (must match for parity): the R3 train/test TSVs have 1-based
user/item ids and explicit ratings; ids are shifted to 0-based, ratings >=
``min_rating`` are kept and binarized to 1.0, user/item counts come from the
train file, and the validation split is 90/10 of train with
``random_state=12345`` (`yahoomusic.py:29-48`).

The R3 dataset requires manual download from the Yahoo Webscope program;
like the reference (`yahoomusic.py:24-27`) instructions are printed when the
data is absent, but a ``FileNotFoundError`` is raised instead of ``exit(1)``
(a known reference wart: libraries should not kill the interpreter).
"""

from __future__ import annotations

from typing import Optional

from .implicit import ImplicitFeedbackDataset

_FILES = {
    "train": "ydata-ymusic-rating-study-v1_0-train.txt",
    "test": "ydata-ymusic-rating-study-v1_0-test.txt",
}


class YahooMusic(ImplicitFeedbackDataset):
    def __init__(self, min_rating: float = 4.0,
                 under_sampling: Optional[int] = None):
        super().__init__("yahoomusic", min_rating)

        if not self.dir_path.exists():
            msg = (
                "download R3 dataset from "
                "https://webscope.sandbox.yahoo.com/catalog.php?datatype=r , "
                f"and put it on {self.dir_path.as_posix()}.")
            print(msg)
            raise FileNotFoundError(msg)

        self.df_train = self._read(_FILES["train"], min_rating)
        self.df_test = self._read(_FILES["test"], min_rating)

        self.num_user = int(self.df_train.user.max()) + 1
        self.num_item = int(self.df_train.item.max()) + 1

        from sklearn.model_selection import train_test_split

        self.df_train, self.df_valid = train_test_split(
            self.df_train, test_size=0.1, random_state=12345)

        self.train = self.to_matrix(self.df_train)
        self.valid = self.to_matrix(self.df_valid)
        self.test = self.to_matrix(self.df_test)
        self._finalize()

    def _read(self, fname: str, min_rating: float) -> "pd.DataFrame":
        """TSV -> 0-based ids, >= min_rating kept and binarized."""
        import pandas as pd

        df = pd.read_csv(self.dir_path.joinpath(fname), sep="\t",
                         names=["user", "item", "rating"])
        df[["user", "item"]] -= 1
        df = df[df["rating"] >= min_rating].copy()
        df["rating"] = 1.0
        return df
