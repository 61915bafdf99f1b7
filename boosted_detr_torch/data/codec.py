"""Host-side text <-> id codec, the port's own copy.

Counterpart of boosted_detr_tpu/data/codec.py (``TextCodec``, :26-115),
copied rather than imported so that the PyTorch package never loads the JAX
package. The model sees only ids and probabilities; strings live here:
- id 0 = '<PAD>' (mask token, doubles as the no-object class), id 1 =
  '<OOV>';
- an attribute is decoded when its probability is >= 0.5;
- decoded attribute strings are comma-joined with <PAD>/<OOV> stripped.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from boosted_detr_torch.config import OOV_TOKEN, PAD_TOKEN


class TextCodec:
    """Bidirectional string<->id codec for category + attribute vocabularies.

    ``vocab_dict`` has keys 'category' and 'attribute' (word lists WITHOUT
    the special tokens)."""

    def __init__(self, vocab_dict: Dict[str, Sequence[str]]):
        self.vocab_dict = {k: list(v) for k, v in vocab_dict.items()}
        self.category_vocab = [PAD_TOKEN, OOV_TOKEN] + self.vocab_dict[
            "category"]
        self.attribute_vocab = [PAD_TOKEN, OOV_TOKEN] + self.vocab_dict[
            "attribute"]
        self._cat_to_id = {w: i for i, w in enumerate(self.category_vocab)}
        self._att_to_id = {w: i for i, w in enumerate(self.attribute_vocab)}

    def vocab_size_dict(self) -> Dict[str, int]:
        return {"category": len(self.category_vocab),
                "attributes": len(self.attribute_vocab)}

    def _lookup(self, table: Dict[str, int], word: str) -> int:
        if word == PAD_TOKEN:
            return 0
        return table.get(word, 1)  # OOV = 1

    def encode_categories(self, categories: Sequence[Sequence[str]],
                          max_objects: int) -> np.ndarray:
        """[B][n_i] category strings -> int32 [B, max_objects] (0 = PAD)."""
        b = len(categories)
        out = np.zeros((b, max_objects), np.int32)
        for i, cats in enumerate(categories):
            for j, c in enumerate(cats[:max_objects]):
                word = c[0] if isinstance(c, (list, tuple)) else c
                out[i, j] = self._lookup(self._cat_to_id, word)
        return out

    def encode_attributes(self, attributes: Sequence[Sequence[Sequence[str]]],
                          max_objects: int, max_words: int) -> np.ndarray:
        """[B][n_i][w_ij] attribute strings -> int32 [B, max_objects,
        max_words] (0 = PAD)."""
        b = len(attributes)
        out = np.zeros((b, max_objects, max_words), np.int32)
        for i, objs in enumerate(attributes):
            for j, words in enumerate(objs[:max_objects]):
                if isinstance(words, str):
                    words = [words]
                for k, w in enumerate(list(words)[:max_words]):
                    out[i, j, k] = self._lookup(self._att_to_id, w)
        return out

    def decode(self, cat_probs: np.ndarray, att_probs: np.ndarray,
               attribute_threshold: float = 0.5
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Probabilities -> text.

        Args:
          cat_probs: [B, P, Vc] softmax probabilities.
          att_probs: [B, P, Va] sigmoid probabilities.

        Returns:
          (category [B, P] str array, attributes [B, P] str array of
          comma-joined attribute names with PAD/OOV removed).
        """
        cat_probs = np.asarray(cat_probs)
        att_probs = np.asarray(att_probs)
        cat_ids = cat_probs.argmax(axis=-1)  # [B, P]
        cat_arr = np.asarray(self.category_vocab, dtype=object)[cat_ids]

        multihot = att_probs >= attribute_threshold  # [B, P, Va]
        b, p, _ = multihot.shape
        att_out = np.empty((b, p), dtype=object)
        names = self.attribute_vocab
        for i in range(b):
            for j in range(p):
                words = [names[k] for k in np.nonzero(multihot[i, j])[0]
                         if k >= 2]  # strip PAD (0) and OOV (1)
                att_out[i, j] = ", ".join(words)
        return cat_arr, att_out

    def decode_predictions(self, preds: Dict[str, np.ndarray],
                           attribute_threshold: float = 0.5):
        """Model output dict -> (category_strings, attribute_strings, boxes)."""
        cats, atts = self.decode(preds["category"], preds["attribute"],
                                 attribute_threshold)
        return cats, atts, np.asarray(preds["boxes"])
