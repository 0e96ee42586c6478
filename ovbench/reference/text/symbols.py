"""Symbol inventory for the cjke_cleaners2 frontend.

This is checkpoint-defining data (text/symbols.py:55-73 in the reference):
token IDs are positions in this list, and released checkpoints embed the same
list in their config.json (`hps.symbols`), which takes precedence at runtime.
87 symbols: pad + punctuation + IPA letters.
"""

_pad = "_"
_punctuation = ",.!?-~…"
_letters = "NQabdefghijklmnopstuvwxyzɑæʃʑçɯɪɔɛɹðəɫɥɸʊɾʒθβŋɦ⁼ʰ`^#*=ˈˌ→↓↑ "

symbols = [_pad] + list(_punctuation) + list(_letters)

SPACE_ID = symbols.index(" ")

# tone bookkeeping for the multilingual (vits2-style) tokenizer variant
num_zh_tones = 6
num_ja_tones = 1
num_en_tones = 4
num_kr_tones = 1

language_tone_start_map = {
    "ZH": 0,
    "JP": num_zh_tones,
    "EN": num_zh_tones + num_ja_tones,
    "KR": num_zh_tones + num_ja_tones + num_en_tones,
}
