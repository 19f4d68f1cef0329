"""Feature-layout specification for the ml-100k CTR feature vector.

The interchange format between the data pipeline and every feature-vector
model is a dense ``[B, 45]`` float32 matrix laid out as

    [user_id, item_id, age, gender(2), occupation(21), genres(19)]

the same layout as the JAX package's ``features.py``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Column layout of the dense feature vector + vocab sizes."""

    num_users: int = 943
    num_items: int = 1682
    num_genders: int = 2
    num_occupations: int = 21
    num_genres: int = 19

    # column indices in the 45-wide feature vector
    user_col: int = 0
    item_col: int = 1
    age_col: int = 2
    gender_slice: tuple = (3, 5)
    occupation_slice: tuple = (5, 26)
    genre_slice: tuple = (26, 45)

    @property
    def width(self) -> int:
        return 2 + 1 + self.num_genders + self.num_occupations + self.num_genres

    @property
    def dense_width(self) -> int:
        """Width of the non-id block (age + one/multi-hot fields): 43."""
        return self.width - 2

    def ids(self, x):
        """(user_ids, item_ids) int64 from the id columns of a [B, width]
        float tensor. The ids are stored as floats, which hold every integer
        only up to 2^24 in float32; bfloat16 and float16 lose ids above 256
        and 2048, so such a tensor raises instead of giving wrong ids."""
        if x.dtype in (torch.bfloat16, torch.float16):
            raise TypeError(f"feature matrix in {x.dtype}: its id columns lose ids above "
                            f"{256 if x.dtype == torch.bfloat16 else 2048}; keep it float32")
        return x[:, self.user_col].long(), x[:, self.item_col].long()

    def split(self, x):
        """Slice a [B, width] feature tensor into its fields.

        Returns (user_ids int64, item_ids int64, age [B,1], gender [B,2],
        occupation [B,21], genres [B,19]).
        """
        user, item = self.ids(x)
        age = x[:, self.age_col : self.age_col + 1]
        gender = x[:, self.gender_slice[0] : self.gender_slice[1]]
        occupation = x[:, self.occupation_slice[0] : self.occupation_slice[1]]
        genres = x[:, self.genre_slice[0] : self.genre_slice[1]]
        return user, item, age, gender, occupation, genres

    def dense(self, x):
        """The 43-wide dense block [age, gender, occupation, genres]."""
        return x[:, self.age_col :]


ML100K_SPEC = FeatureSpec()
