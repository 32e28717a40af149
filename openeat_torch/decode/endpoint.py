"""CTC-based endpoint detection for the streaming runtimes (host).
Port of openeat_tpu/decode/endpoint.py.

The WeNet/kaldi rules over the greedy CTC path; "silence" is a run of
blank frames at the decoded tail, in encoder positions (one position =
subsampling rate x 10 ms of audio):

  rule 1: nothing decoded yet and trailing silence >= 5000 ms;
  rule 2: something decoded and trailing silence >= 1000 ms;
  rule 3: the decoded utterance reached 20000 ms, silence or not.

Bookkeeping on the host over the per-frame argmax tokens the chunk step
already returns: no device work.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EndpointConfig:
    """Thresholds in milliseconds (the WeNet defaults)."""
    rule1_min_trailing_silence: float = 5000.0
    rule2_min_trailing_silence: float = 1000.0
    rule3_min_utterance_length: float = 20000.0


class Endpointer:
    """Feed each chunk's greedy frame tokens; `detected` latches True.
    frame_ms: audio ms of one encoder position (40 for conv2d x4)."""

    def __init__(self, config: EndpointConfig | None = None, *,
                 frame_ms: float = 40.0, blank_id: int = 0):
        self.config = config or EndpointConfig()
        self.frame_ms = frame_ms
        self.blank_id = blank_id
        self.n_frames = 0          # decoded encoder positions so far
        self.trailing_blanks = 0   # blanks in a row at the tail
        self.spoke = False         # any non-blank frame seen
        self.detected = False

    def feed(self, frame_tokens) -> bool:
        """Take the argmax token of each newly decoded frame, in order;
        returns the latched decision."""
        for t in frame_tokens:
            self.n_frames += 1
            if int(t) == self.blank_id:
                self.trailing_blanks += 1
            else:
                self.trailing_blanks = 0
                self.spoke = True
        c = self.config
        silence_ms = self.trailing_blanks * self.frame_ms
        utt_ms = self.n_frames * self.frame_ms
        if not self.detected:
            self.detected = (
                (not self.spoke
                 and silence_ms >= c.rule1_min_trailing_silence)
                or (self.spoke
                    and silence_ms >= c.rule2_min_trailing_silence)
                or (self.spoke and utt_ms >= c.rule3_min_utterance_length))
        return self.detected
