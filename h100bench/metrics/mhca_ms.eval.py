"""Mean device time of MPViT's factorised-attention encoders per request:
the sum, over a request's stages, of the device ms of the program's spans
``backbone.stage{s}.mhca`` (every path encoder of stage ``s``), averaged
over the traced slice's requests. A program without those spans gives
None."""

import re
from collections import defaultdict

from harness.program_trace import spans

NAME = re.compile(r"backbone\.stage\d+\.mhca")


def read(ctx):
    per_request = defaultdict(float)
    for s in spans(ctx) or ():
        if NAME.fullmatch(s.name) and s.device_ms is not None:
            per_request[s.request] += s.device_ms
    return sum(per_request.values()) / len(per_request) if per_request else None
