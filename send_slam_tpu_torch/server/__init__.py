"""Server layer: the reference's external contract.

- HTTP/WebSocket on :4000 (SendSlam.WebServer, web_server.ex:7-29):
  ``GET /`` panel page, ``GET /panel`` WS (binary JPEG frames +
  calibration upload), ``GET /client`` WS (pose JSON stream).
- TCP on :5000 (ThousandIsland + SlamHandler, application.ex:80):
  length-prefixed MessagePack frame/calibration out, poses in — so an
  unmodified reference backend container can still be plugged in.
- Backend role (orbslam3_mono_networked.cc as a TCP client): our engine
  can itself dial a reference host, consume frame/calibration packets
  and stream poses back — drop-in replacement for the docker backend.

The port's serving path (the JAX package's ``server/``, module for
module): it runs on the card unless the caller passes ``device="cpu"``,
imports neither ``msgpack`` nor ``aiohttp`` (``io/msgpack_codec.py`` and
``server/http.py`` take their place) and imports ``cv2`` only inside the
functions that read formats other than PPM/PGM. ``GET /panel`` (JPEG
frames and the calibration upload) waits for the calibration pipeline's
port.
"""
