"""A draw source for the port's comms engine that returns the JAX
package's own draws, so that a test can hold the two engines against each
other bit for bit.  Imported by the parity tests after
``pytest.importorskip("jax")``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.comms import layer as jlayer
from repro.comms.spec import CommSpec as JCommSpec

_TO_OIHW = (0, 4, 3, 1, 2)
_TO_HWIO = (0, 3, 4, 2, 1)


class JaxDraws:
    """A draw source that returns the JAX package's draws for the port's
    streams: ``slot`` (quantization / sketch, index = leaf) and
    ``slot/chan/{sched,drop,straggle}`` (channel, index = hop)."""

    def __init__(self, comm, channel=None):
        self.comm = comm
        self.channel = channel
        self.base = jax.random.PRNGKey(comm.seed)

    def _round(self, slot, rnd):
        key = jax.random.fold_in(
            jax.random.fold_in(self.base, jlayer._salt(slot)), rnd)
        return jax.random.split(key)

    def _quant_key(self, stream, rnd, index):
        return jax.random.fold_in(self._round(stream, rnd)[0], index)

    @staticmethod
    def _port_layout(a, shape):
        a = np.asarray(a)
        return a.transpose(_TO_OIHW) if len(shape) == 5 else a

    @staticmethod
    def _jax_shape(shape):
        return tuple(shape[i] for i in _TO_HWIO) if len(shape) == 5 \
            else tuple(shape)

    def uniform(self, stream, rnd, index, shape, device):
        parts = stream.split("/")
        if len(parts) == 1:
            u = jax.random.uniform(self._quant_key(stream, rnd, index),
                                   self._jax_shape(shape), jnp.float32)
            return torch.from_numpy(self._port_layout(u, shape).copy())
        slot, _, what = parts
        key = jax.random.fold_in(self._round(slot, rnd)[1], index)
        keys = {}
        if self.comm.schedule == "matching":
            keys["sched"], key = jax.random.split(key)
        if self.comm.drop_rate > 0.0:
            keys["drop"], key = jax.random.split(key)
        if self.comm.straggler_rate > 0.0:
            keys["straggle"], key = jax.random.split(key)
        if what == "sched":
            m = self.channel.n_subsets
            pick = int(jax.random.randint(keys["sched"], (), 0, m))
            return torch.tensor((pick + 0.5) / m, dtype=torch.float32)
        u = jax.random.uniform(keys[what], shape, jnp.float32)
        return torch.from_numpy(np.asarray(u).copy())

    def normal(self, stream, rnd, index, shape, device):
        omega = jax.random.normal(self._quant_key(stream, rnd, index), shape,
                                  jnp.float32)
        return torch.from_numpy(np.asarray(omega).copy())


class ElasticJaxDraws(JaxDraws):
    """:class:`JaxDraws` for the elastic engine.

    Elastic mode carries its fault rates on ``ElasticSpec`` under a
    disabled (or compression-only) ``CommSpec``, so the channel keys split
    in the order ``ElasticSpec.drop_rate`` / ``straggler_rate`` give (drop,
    then straggle; no schedule split).  The churn streams
    ``elastic/churn/{leave,join}`` return the uniforms behind the JAX
    package's ``ChurnSchedule.active``: ``k_leave, k_join =
    split(fold_in(PRNGKey(ElasticSpec.seed), rnd))``, one ``uniform((n,))``
    each (``bernoulli(k, p, shape)`` is ``uniform(k, shape) < p``)."""

    def __init__(self, elastic, comm=None):
        comm = comm if comm is not None and comm.enabled else JCommSpec()
        super().__init__(dataclasses.replace(
            comm, drop_rate=elastic.drop_rate,
            straggler_rate=elastic.straggler_rate))
        self.elastic = elastic

    def churn_keys(self, rnd):
        """(k_leave, k_join) of round ``rnd``."""
        return tuple(jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(self.elastic.seed), rnd)))

    def uniform(self, stream, rnd, index, shape, device):
        if stream.startswith("elastic/churn/"):
            k_leave, k_join = self.churn_keys(rnd)
            key = k_leave if stream.endswith("/leave") else k_join
            u = jax.random.uniform(key, tuple(shape), jnp.float32)
            return torch.from_numpy(np.asarray(u).copy())
        return super().uniform(stream, rnd, index, shape, device)
