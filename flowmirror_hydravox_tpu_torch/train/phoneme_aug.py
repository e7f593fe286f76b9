# Copied from flowmirror_hydravox_tpu/train/phoneme_aug.py; the port keeps its own copy.
"""Phoneme-substitution text augmentation for LLM (pre)training.

Mirrors the reference collators' augmentation
(reference scripts/train/train_llm_pretrain.py:86-195,
train_speech_model.py:550-565):

  - If the text contains English words: pick up to 2 at random, replace each
    with its CMU/ARPABET phone sequence rendered as tokenizer special tokens,
    e.g. "hello" -> " [HH][AH0][L][OW1] " (no spaces between specials, one
    space on each side).
  - Otherwise (text unchanged): pick 2 random Chinese characters and replace
    each with "[initial][final-with-tone-mark]" special tokens,
    e.g. "中" -> " [zh][ōng] ".
  - A phone/pinyin token is only used when it is registered in the
    tokenizer's special inventory; failed lookups leave the text unchanged.

Grapheme-to-phoneme sources are pluggable because cmudict/pronouncing and
pypinyin are optional dependencies: their imports are tried first, then a
user-supplied lexicon (HYDRAVOX_CMU_LEXICON / HYDRAVOX_PINYIN_LEXICON env
vars or constructor args), else that language's augmentation is skipped.
"""

from __future__ import annotations

import logging
import os
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("hydravox.phoneme_aug")

_RE_EN_WORD = re.compile(r"[A-Za-z]+(?:'[A-Za-z]+)?")
_RE_ZH_CHAR = re.compile(r"[一-鿿]")

# numeric-tone -> tone-marked vowel (standard pinyin orthography); the
# reference gets tone-marked finals from pypinyin Style.FINALS_TONE
_TONE_MARKS = {
    "a": "aāáǎà", "o": "oōóǒò", "e": "eēéěè",
    "i": "iīíǐì", "u": "uūúǔù", "v": "üǖǘǚǜ", "ü": "üǖǘǚǜ",
}
_PINYIN_INITIALS = (
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w",
)


def numeric_pinyin_to_tone_final(syllable: str) -> Tuple[str, str]:
    """'zhong1' -> ('zh', 'ōng'); '' initial for zero-initial syllables.

    Tone-mark placement: mark 'a' if present, else 'o'/'e', else the last
    vowel (covers 'iu'/'ui')."""
    syllable = syllable.strip().lower()
    tone = 0
    if syllable and syllable[-1] in "012345":
        tone = int(syllable[-1]) % 5  # 5 (neutral) -> no mark, like tone 0
        syllable = syllable[:-1]
    initial = ""
    for ini in _PINYIN_INITIALS:
        if syllable.startswith(ini):
            initial = ini
            break
    final = syllable[len(initial):]
    if not final:
        return initial, ""
    # pick the vowel to mark
    mark_idx = None
    for pref in ("a", "o", "e"):
        if pref in final:
            mark_idx = final.index(pref)
            break
    if mark_idx is None:
        for i in range(len(final) - 1, -1, -1):
            if final[i] in "iuvü":
                mark_idx = i
                break
    if tone and mark_idx is not None and final[mark_idx] in _TONE_MARKS:
        marked = _TONE_MARKS[final[mark_idx]][tone]
        final = final[:mark_idx] + marked + final[mark_idx + 1 :]
    elif final and final[0] == "v":
        final = "ü" + final[1:]
    return initial, final


def _load_cmu_lexicon(path: str) -> Dict[str, List[str]]:
    """cmudict-format lexicon: 'WORD  P1 P2 ...' (';;;' comments,
    'WORD(2)' alternates ignored)."""
    lex: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if not line.strip() or line.startswith(";;;"):
                continue
            parts = line.split()
            word = parts[0].lower()
            if "(" in word:
                continue
            lex.setdefault(word, parts[1:])
    return lex


def _load_pinyin_lexicon(path: str) -> Dict[str, str]:
    """Per-char lexicon: '中 zhong1' per line (numeric-tone pinyin)."""
    lex: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and len(parts[0]) == 1:
                lex.setdefault(parts[0], parts[1])
    return lex


class PhonemeAugmenter:
    """Callable text augmenter; construct once, apply per collator item."""

    def __init__(
        self,
        special_tokens: Sequence[str],
        cmu_lexicon: Optional[Dict[str, List[str]]] = None,
        pinyin_lexicon: Optional[Dict[str, str]] = None,
        seed: Optional[int] = None,
    ):
        self.specials = set(special_tokens)
        self.rng = random.Random(seed)
        self._cmu = cmu_lexicon
        self._pinyin = pinyin_lexicon
        self._pypinyin = None
        if self._cmu is None:
            self._cmu = self._auto_cmu()
        if self._pinyin is None:
            self._pypinyin = self._auto_pypinyin()
            if self._pypinyin is None:
                path = os.environ.get("HYDRAVOX_PINYIN_LEXICON")
                if path and os.path.exists(path):
                    self._pinyin = _load_pinyin_lexicon(path)
        if self._cmu is None and self._pinyin is None and self._pypinyin is None:
            logger.warning(
                "phoneme augmentation has no G2P source (cmudict/pronouncing/"
                "pypinyin absent, no HYDRAVOX_CMU_LEXICON/HYDRAVOX_PINYIN_LEXICON)"
                " — texts pass through unchanged"
            )

    @staticmethod
    def _auto_cmu() -> Optional[Dict[str, List[str]]]:
        try:
            import cmudict  # type: ignore

            return {w: p[0] for w, p in cmudict.dict().items() if p}
        except Exception:
            pass
        try:
            import pronouncing  # type: ignore

            class _Lazy(dict):
                def get(self, w, default=None):
                    ps = pronouncing.phones_for_word(w)
                    return ps[0].split() if ps else default

            return _Lazy()
        except Exception:
            pass
        path = os.environ.get("HYDRAVOX_CMU_LEXICON")
        if path and os.path.exists(path):
            return _load_cmu_lexicon(path)
        return None

    @staticmethod
    def _auto_pypinyin():
        try:
            from pypinyin import Style, pinyin  # type: ignore

            def g2p(ch: str) -> Tuple[str, str]:
                ini = pinyin(ch, style=Style.INITIALS, strict=False, heteronym=False)[0][0] or ""
                fin = pinyin(ch, style=Style.FINALS_TONE, strict=False, heteronym=False)[0][0] or ""
                return ini, fin

            return g2p
        except Exception:
            return None

    # -- per-language passes (reference train_llm_pretrain.py:86-195) --------

    def _en_pass(self, text: str) -> str:
        if self._cmu is None:
            return text
        matches = list(_RE_EN_WORD.finditer(text))
        if not matches:
            return text
        picks = self.rng.sample(matches, k=min(2, len(matches)))
        replacements = []
        for m in picks:
            phones = self._cmu.get(m.group(0).lower())
            if not phones:
                continue
            toks = [f"[{p}]" for p in phones if f"[{p}]" in self.specials]
            if not toks:
                continue
            replacements.append((m.start(), m.end(), " " + "".join(toks) + " "))
        for s, e, rep in sorted(replacements, key=lambda x: x[0], reverse=True):
            text = text[:s] + rep + text[e:]
        return text

    def _zh_pass(self, text: str) -> str:
        matches = list(_RE_ZH_CHAR.finditer(text))
        if len(matches) < 2:
            return text
        picks = self.rng.sample(matches, k=2)
        replacements = []
        for m in picks:
            ch = m.group(0)
            if self._pypinyin is not None:
                try:
                    ini, fin = self._pypinyin(ch)
                except Exception:
                    continue
            elif self._pinyin is not None:
                syl = self._pinyin.get(ch)
                if not syl:
                    continue
                ini, fin = numeric_pinyin_to_tone_final(syl)
            else:
                return text
            toks = []
            for part in (ini, fin):
                tok = f"[{part.lower()}]"
                if part and tok in self.specials:
                    toks.append(tok)
            if toks:
                replacements.append((m.start(), m.end(), " " + "".join(toks) + " "))
        for s, e, rep in sorted(replacements, key=lambda x: x[0], reverse=True):
            text = text[:s] + rep + text[e:]
        return text

    def __call__(self, text: str) -> str:
        """English first; Chinese only when the English pass changed nothing
        (reference train_speech_model.py:556-559)."""
        new_text = self._en_pass(text)
        if new_text == text:
            new_text = self._zh_pass(text)
        return new_text
