"""The stages of the cascade, one module a stage: `stages/<stage>.py`, found
by the `"stage"` of a configuration (data.py, `BenchData.stage`). A stage,
its reference, its configuration and its cell are added as new files; the
harness names no stage. A stage module gives:

Building and calling (program.py, harness.py)
  build(config, device)            the stage's pipeline of `lavie_tpu_torch`,
                                   every keyword from the configuration file
  call(pipe, config, workload, traffic, req, steps)
                                   one request as a whole call of the pipeline;
                                   returns (the video on the host, the final
                                   latents, or None for the last sampler
                                   step's output)
Observing (window.py)
  UNET_CALLS                       the UNet methods one denoising step calls,
                                   in order ("__call__" for the module call);
                                   the first opens the step
  keep(req, config, method, args, kwargs)
                                   called on each UNet call of a request's
                                   first step: keeps `req.states` (the text
                                   states) and `req.extra` (the conditioning
                                   channels)
  sampler(config)                  (object, attribute) of the sampler step
                                   that the pipeline calls once a step
  step_io(args, kwargs, out)       that step's (t, prev_t, x_k, prediction,
                                   x_k+1)
  VAE_TIMED                        the VAE methods `vae_ms` times
Reference (check.py)
  NUMBERS                          the numbers compared, in order; each has a
                                   limit in the cell's workload file
  Reference(config, workload, seed, device)
                                   the fp32 networks (reference/models.py or
                                   reference/<stage>.py) with the seed's
                                   weights: set_numerics(num), step(x, eps, t,
                                   prev, noise, num), decode(latents)
  Expected(r, req, traffic)        the reference's side of one request:
                                   `states`, `x0`, `extra` (None without
                                   conditioning; its number is
                                   `extra_number`), `noise` and `eps` by kept
                                   step; built in the control's numerics it
                                   is the control's side too
Yardstick (harness.py, count_flops.py)
  bounds(config, workload)         kernel → its bound seconds over the call
                                   sites of one denoising step at the cell's
                                   batch (yardstick.py's bound functions)
  count(config, workload)          the operation counts counts/<cell>.json
                                   holds; `flops_per_step` a denoising step
Spans (spans.py)
  span_counts(config)              (unet spans a step, resnet spans a unet
                                   span, transformer spans a unet span)
Tests (tests/tiny.py)
  tiny(config, workload)           both cut to tiny widths and sizes, for the
                                   harness's runs on the CPU
"""
