"""MovieLens loader (rebuild of `/root/reference/cymf/dataset/movielens.py`).

Exact split protocol for metric parity (`movielens.py:62-66`):

* dense id remap of raw user/item ids (insertion order over ``set(column)``);
* keep ratings >= ``min_rating`` (default 4.0), binarize to 1.0;
* 90/10 train/test split then 90/10 train/valid split, both
  ``sklearn.model_selection.train_test_split`` with ``random_state=12345``.

Downloads from grouplens via urllib when the file is absent (the reference
uses the ``wget`` package, `movielens.py:31-40`).  A pre-downloaded zip or
extracted directory under ``~/.cymf_tpu`` (or ``~/.cymf``) is used as-is, so
air-gapped machines can be provisioned manually.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Dict, Optional

from .implicit import ImplicitFeedbackDataset


def _download(url: str, out: Path) -> None:
    import urllib.request
    print(f"downloading {url} ...")
    urllib.request.urlretrieve(url, str(out))


class MovieLens(ImplicitFeedbackDataset):
    def __init__(self, dir_name: str = "ml-100k", min_rating: float = 4.0,
                 under_sampling: Optional[int] = None):
        super().__init__(dir_name, min_rating)

        if dir_name not in ("ml-100k", "ml-1m", "ml-10m", "ml-20m", "ml-25m"):
            raise ValueError(
                "dir_name must be one of 'ml-100k', 'ml-1m', 'ml-10m', "
                "'ml-20m', 'ml-25m'.")

        from sklearn.model_selection import train_test_split

        self._ensure_files(dir_name)
        print("loading movielens...")
        df_all = self._read_ratings(dir_name)

        df_all.item = self.reset_id(df_all.item)
        df_all.user = self.reset_id(df_all.user)
        self.num_user = len(set(df_all.user))
        self.num_item = len(set(df_all.item))

        df_all = df_all[df_all["rating"] >= self.min_rating]
        df_all = df_all.copy()
        df_all["rating"] = 1.0

        self.df_train, self.df_test = train_test_split(
            df_all, test_size=0.1, random_state=12345)
        self.df_train, self.df_valid = train_test_split(
            self.df_train, test_size=0.1, random_state=12345)

        self.train = self.to_matrix(self.df_train)
        self.valid = self.to_matrix(self.df_valid)
        self.test = self.to_matrix(self.df_test)
        self._finalize()

    # -- files ---------------------------------------------------------------
    def _ensure_files(self, dir_name: str) -> None:
        if self.dir_path.exists():
            return
        # also accept the reference's cache dir for shared provisioning
        legacy = Path.home().joinpath(".cymf", dir_name)
        if legacy.exists():
            self.dir_path = legacy
            return
        zip_path = self.dir_path.parent.joinpath(dir_name + ".zip")
        if not zip_path.exists():
            print("movielens file does not exist, downloading ...")
            _download(
                f"http://files.grouplens.org/datasets/movielens/{dir_name}.zip",
                zip_path)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(self.dir_path.parent)
        # ml-10m extracts as "ml-10M100K"
        if dir_name == "ml-10m" and not self.dir_path.exists():
            extracted = self.dir_path.parent.joinpath("ml-10M100K")
            if extracted.exists():
                extracted.rename(self.dir_path)

    def _read_ratings(self, dir_name: str) -> "pd.DataFrame":
        import pandas as pd

        if dir_name == "ml-100k":
            return pd.read_csv(self.dir_path.joinpath("u.data"), sep="\t",
                               names=("user", "item", "rating", "timestamp"))
        if dir_name in ("ml-1m", "ml-10m"):
            return pd.read_csv(self.dir_path.joinpath("ratings.dat"),
                               sep="::", engine="python",
                               names=("user", "item", "rating", "timestamp"))
        # ml-20m / ml-25m ship a CSV with a header row
        df = pd.read_csv(self.dir_path.joinpath("ratings.csv"))
        df.columns = ("user", "item", "rating", "timestamp")
        return df

    def reset_id(self, column: "pd.Series") -> "pd.Series":
        """Dense id remap (`movielens.py:76-85`): ids are assigned in the
        iteration order of ``set(column)`` — replicated exactly so the
        user/item numbering matches the reference."""
        x2index: Dict[int, int] = {}
        for x in set(column):
            if x not in x2index:
                x2index[x] = len(x2index)
        return column.map(lambda x: x2index[x])
