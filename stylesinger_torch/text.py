"""Phone-set token encoder (a copy of ``stylesinger_tpu/text.py``'s
``TokenTextEncoder`` and ``build_token_encoder``, the parts inference uses).

Reserved tokens ``<pad>=0, <EOS>=1, <UNK>=2``; out-of-vocabulary phones map
to ``<UNK>``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

PAD = "<pad>"
EOS = "<EOS>"
UNK = "<UNK>"
RESERVED_TOKENS = [PAD, EOS, UNK]


class TokenTextEncoder:
    """Maps space-separated phone strings to integer id lists."""

    def __init__(self, vocab_list: Sequence[str],
                 replace_oov: Optional[str] = UNK):
        vocab = list(RESERVED_TOKENS) + [
            v for v in vocab_list if v not in RESERVED_TOKENS]
        self._token_to_id = {tok: i for i, tok in enumerate(vocab)}
        self._replace_oov = replace_oov

    def encode(self, s: str) -> List[int]:
        tokens = s.strip().split()
        if self._replace_oov is not None:
            tokens = [t if t in self._token_to_id else self._replace_oov
                      for t in tokens]
        return [self._token_to_id[t] for t in tokens]

    def __len__(self) -> int:
        return len(self._token_to_id)


def build_token_encoder(phones: Sequence[str]) -> TokenTextEncoder:
    """From a phone list (sorted, deduplicated)."""
    return TokenTextEncoder(sorted(set(phones)))
