from .traces import (get_trace, alibaba_chat, azure_code, azure_conv,
                     sinusoidal_decode_load, synthesize, TraceSpec, TRACES)
