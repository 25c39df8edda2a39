from sdr_tpu.app.cli import main
from sdr_tpu.utils.cache import enable_compile_cache

enable_compile_cache()
raise SystemExit(main())
