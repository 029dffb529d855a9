"""Phone-set token encoder (a copy of ``stylesinger_tpu/text.py``).

A vocabulary-backed encoder with reserved tokens ``<pad>=0, <EOS>=1,
<UNK>=2`` and a ``|`` segment marker, built from a phone list or a
``phone_set.json`` file; out-of-vocabulary phones map to ``<UNK>``.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Sequence

PAD = "<pad>"
EOS = "<EOS>"
UNK = "<UNK>"
SEG = "|"
RESERVED_TOKENS = [PAD, EOS, UNK]
PAD_ID, EOS_ID, UNK_ID = 0, 1, 2


class TokenTextEncoder:
    """Maps space-separated phone strings <-> integer id lists."""

    def __init__(self, vocab_list: Sequence[str],
                 add_reserved: bool = True,
                 replace_oov: Optional[str] = UNK):
        if add_reserved:
            vocab = list(RESERVED_TOKENS) + [
                v for v in vocab_list if v not in RESERVED_TOKENS]
        else:
            vocab = list(vocab_list)
        self._id_to_token = {i: tok for i, tok in enumerate(vocab)}
        self._token_to_id = {tok: i for i, tok in self._id_to_token.items()}
        self._replace_oov = replace_oov
        self.pad_index = self._token_to_id[PAD]
        self.eos_index = self._token_to_id[EOS]
        self.unk_index = self._token_to_id[UNK]
        self.seg_index = self._token_to_id.get(SEG, self.eos_index)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "TokenTextEncoder":
        """Load from a ``phone_set.json`` (list of phones) or a newline vocab
        file (which already includes reserved tokens)."""
        if path.endswith(".json"):
            with open(path) as f:
                phones = json.load(f)
            return cls(sorted(phones), add_reserved=True)
        with open(path) as f:
            vocab = [line.strip() for line in f if line.strip()]
        return cls(vocab, add_reserved=False)

    @classmethod
    def build(cls, phones: Iterable[str]) -> "TokenTextEncoder":
        return cls(sorted(set(phones)), add_reserved=True)

    def store_to_file(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if path.endswith(".json"):
            phones = [self._id_to_token[i]
                      for i in range(len(RESERVED_TOKENS), len(self))]
            with open(path, "w") as f:
                json.dump(phones, f, ensure_ascii=False)
        else:
            with open(path, "w") as f:
                for i in range(len(self)):
                    f.write(self._id_to_token[i] + "\n")

    # -- encode / decode ---------------------------------------------------
    def encode(self, s: str) -> List[int]:
        tokens = s.strip().split()
        if self._replace_oov is not None:
            tokens = [t if t in self._token_to_id else self._replace_oov
                      for t in tokens]
        return [self._token_to_id[t] for t in tokens]

    def decode(self, ids: Sequence[int], strip_eos: bool = False,
               strip_padding: bool = False) -> str:
        ids = list(ids)
        if strip_padding and self.pad_index in ids:
            ids = ids[: ids.index(self.pad_index)]
        if strip_eos and self.eos_index in ids:
            ids = ids[: ids.index(self.eos_index)]
        return " ".join(self._id_to_token.get(int(i), UNK) for i in ids)

    def decode_list(self, ids: Sequence[int]) -> List[str]:
        return [self._id_to_token.get(int(i), UNK) for i in ids]

    # -- helpers -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._id_to_token)

    @property
    def vocab_size(self) -> int:
        return len(self)

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def sil_phonemes(self) -> List[str]:
        """Silence-like phones (reference: tokens starting with '<' plus
        the segment marker '|')."""
        return [p for p in self._token_to_id if p == SEG or p.startswith("<")]


def build_token_encoder(phones_or_path) -> TokenTextEncoder:
    """From a ``phone_set.json`` path or a phone list (reference
    ``build_token_encoder``, utils/text_encoder.py)."""
    if isinstance(phones_or_path, str):
        return TokenTextEncoder.from_file(phones_or_path)
    return TokenTextEncoder(sorted(set(phones_or_path)))
